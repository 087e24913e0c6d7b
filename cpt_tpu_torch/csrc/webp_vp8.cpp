// WEBP lossy (VP8 key frame) decoder of the port's image codec (no library
// beyond the C++ standard one; built by kernels/build.py with the host C++
// compiler and bound with ctypes by utils/image_codec.py).
//
// It gives libwebp 1.6.0's RGB output bit for bit, as Pillow 12.1 reads a
// WEBP file. The bitstream is RFC 6386's: the frame tag and start code, the
// boolean decoder (libwebp's VP8BitReader on a 64-bit host, whose end-of-
// data points decide which damaged files fail: it reads zeros past the end
// of a partition, and the frame fails when a token partition, or the first
// partition at the end of a macroblock row, was read past it), segments
// with their quantizer and filter level, the loop-filter deltas, 1, 2, 4 or
// 8 token partitions, the dequantisation tables (y2 DC x2, y2 AC x155/100
// and at least 8, UV DC at most 132), the skip flag, 16x16, chroma 8x8 and
// 4x4 intra prediction (127 above the frame, 129 left of it; a right-column
// 4x4 block takes its top-right pixels from the macroblock above and to
// the right), the inverse WHT and DCT with the 20091 / 35468 multipliers,
// the simple and the normal loop filter (macroblock edges before inner
// edges, a skipped macroblock without coefficients unfiltered inside). The
// clamping_type bit is ignored (libwebp always clamps). YUV 4:2:0 goes to
// RGB as libwebp's default output: its fancy upsampler (two rounded
// averages along the diagonals, which equal one (9, 3, 3, 1) / 16 rounding
// with bias 8) and its 14-bit fixed-point conversion.
//
// The entry point returns 0 on success and a negative status with a
// message in ``err`` on failure; ``fault`` selects the named faults that
// the checks use to show their digests can fail (0 in use).

#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum Fault {
  kNoLoopFilter = 2048,          // the loop filter skipped
  kBoxUpsample = 4096,           // chroma replicated, not interpolated
  kSingleRoundUpsample = 8192,   // libjpeg's (9, 3, 3, 1) / 16, bias 8 / 7
  kFloatYuv = 16384,             // YUV -> RGB in float arithmetic
  kTopRightFromCurrent = 32768,  // 4x4 top-right from the current macroblock
};

struct WebpError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw WebpError(msg); }

// RFC 6386's tables, in libwebp's order of the 4x4 modes.
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
         {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
         {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
         {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
         {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
         {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
         {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
         {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
         {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
         {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
         {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
         {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
         {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
         {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
         {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
         {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
         {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
         {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
         {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
         {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
         {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
         {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
         {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
         {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
         {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
         {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
         {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
         {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
         {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
         {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
         {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
         {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
         {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
         {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
         {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
         {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
         {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
         {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
         {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
         {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
         {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
         {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
         {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
         {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
         {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
         {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
         {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
         {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
         {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
         {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
         {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
         {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
         {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
         {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
         {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
         {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};

const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6,
};

const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};

// ----------------------------------------------------------- bit reader

// libwebp's VP8BitReader with 56 bits loaded at a time (a 64-bit host):
// ``range`` holds the range minus one; past the data it appends one byte of
// zeros and sets ``eof``.
struct BoolReader {
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* max = nullptr;

  void init(const uint8_t* start, size_t size) {
    range = 254;
    value = 0;
    bits = -8;
    eof = false;
    buf = start;
    end = start + size;
    max = size >= 8 ? start + size - 8 + 1 : start;
    load_new_bytes();
  }
  void load_final() {
    if (buf < end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  void load_new_bytes() {
    if (buf < max) {
      uint64_t in = 0;
      for (int i = 0; i < 8; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = (in >> 8) | (value << 56);
      bits += 56;
    } else {
      load_final();
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load_new_bytes();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {
    if (bits < 0) load_new_bytes();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = (int)get_value(n);
    return get_value(1) ? -v : v;
  }
};

// ------------------------------------------------------------- pixels

constexpr int BPS = 32;  // the work buffer's stride
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = MUL2(in[4]) - MUL1(in[12]);
    const int d = MUL1(in[4]) + MUL2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = MUL2(tmp[4]) - MUL1(tmp[12]);
    const int d = MUL1(tmp[4]) + MUL2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// libwebp's SSE2 transform (the one its x86-64 builds run for a block with
// more than three coefficients): the same steps in wrapping 16-bit lanes,
// the constants as 16-bit offsets from 1.0, and a saturating pack. Equal to
// transform_one for every block a valid stream holds; a damaged stream can
// overflow the lanes, and then this is what libwebp outputs.
inline int16_t w16(int v) { return (int16_t)(uint16_t)v; }
inline int16_t mulhi(int16_t a, int k) { return (int16_t)(((int32_t)a * k) >> 16); }

void transform_sse2(const int16_t* in, uint8_t* dst) {
  int16_t T[4][4], U[4][4];
  for (int j = 0; j < 4; ++j) {  // vertical pass, lane j = column j
    const int16_t i0 = in[j], i1 = in[4 + j], i2 = in[8 + j], i3 = in[12 + j];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
    T[0][j] = w16(a + d);
    T[1][j] = w16(b + c);
    T[2][j] = w16(b - c);
    T[3][j] = w16(a - d);
  }
  for (int j = 0; j < 4; ++j) {  // horizontal pass over the transpose
    const int16_t t0 = T[j][0], t1 = T[j][1], t2 = T[j][2], t3 = T[j][3];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t c = w16(w16(t1 - t3) + w16(mulhi(t1, -30068) - mulhi(t3, 20091)));
    const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, 20091) + mulhi(t3, -30068)));
    U[j][0] = (int16_t)(w16(a + d) >> 3);
    U[j][1] = (int16_t)(w16(b + c) >> 3);
    U[j][2] = (int16_t)(w16(b - c) >> 3);
    U[j][3] = (int16_t)(w16(a - d) >> 3);
  }
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(w16(dst[x + y * BPS] + U[y][x]));
  }
}

// libwebp's DoTransform: by the block's code (nz_code_bits) the SSE2
// transform, or the C one (libwebp's DC-only and three-coefficient
// transforms, which equal it on their inputs), or nothing.
void add_block(int code, const int16_t* coeffs, uint8_t* dst) {
  if (code == 3) {
    transform_sse2(coeffs, dst);
  } else if (code) {
    transform_one(coeffs, dst);
  }
}

// libwebp's DoUVTransform over one chroma plane's four blocks.
void add_uv_blocks(const int* codes, const int16_t* coeffs, uint8_t* dst) {
  bool any = false, ac = false;
  for (int n = 0; n < 4; ++n) {
    any = any || codes[n];
    ac = ac || codes[n] >= 2;
  }
  if (!any) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (ac) {
      transform_sse2(coeffs + n * 16, d);
    } else if (coeffs[n * 16]) {
      transform_one(coeffs + n * 16, d);
    }
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill_block(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, (size_t)size);
}

void predict16(uint8_t* dst, int mode) {
  int dc = 0;
  switch (mode) {
    case DC_PRED:
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill_block(dst, (dc + 16) >> 5, 16);
      break;
    case TM_PRED: true_motion(dst, 16); break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_NOTOP:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill_block(dst, dc >> 4, 16);
      break;
    case DC_NOLEFT:
      dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill_block(dst, dc >> 4, 16);
      break;
    default: fill_block(dst, 0x80, 16);
  }
}

void predict8(uint8_t* dst, int mode) {
  int dc = 0;
  switch (mode) {
    case DC_PRED:
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, (dc + 8) >> 4, 8);
      break;
    case TM_PRED: true_motion(dst, 8); break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_NOTOP:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill_block(dst, dc >> 3, 8);
      break;
    case DC_NOLEFT:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill_block(dst, dc >> 3, 8);
      break;
    default: fill_block(dst, 0x80, 8);
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, AVG3(X, I, J), 4);
      std::memset(dst + 1 * BPS, AVG3(I, J, K), 4);
      std::memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      std::memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_LD_PRED:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VL_PRED:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
  }
}

// ---------------------------------------------------------- loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * vstride, hstride, t2)) filter2(p + i * vstride, hstride);
  }
}

// hstride: across the edge; vstride: along it
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t)) {
        filter2(p, hstride);
      } else if (mb_edge) {
        filter6(p, hstride);
      } else {
        filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// -------------------------------------------------------------- decoder

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0;
  bool inner = false;
};

struct MB {  // the contexts libwebp keeps per column (and one for the left)
  uint8_t nz = 0, nz_dc = 0;
};

struct Block {
  uint8_t imodes[16];
  bool is_i4x4;
  uint8_t uvmode, segment, skip;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  int fault;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_m1 = 0;
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, filter_type = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];

  std::vector<uint8_t> Y, U, V;  // mb_w*16 x mb_h*16 and the chroma halves
  int ystride = 0, uvstride = 0;

  Decoder(const uint8_t* d, size_t n, int f) : data(d), size(n), fault(f) {}

  void parse_headers() {
    const uint8_t* buf = data;
    size_t left = size;
    if (left < 4) fail("broken WEBP lossy bitstream (truncated header)");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) fail("broken WEBP lossy bitstream (incorrect keyframe parameters)");
    if (!show) fail("broken WEBP lossy bitstream (frame not displayable)");
    buf += 3;
    left -= 3;
    if (key_frame) {
      if (left < 7) fail("broken WEBP lossy bitstream (cannot parse picture header)");
      if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) {
        fail("broken WEBP lossy bitstream (bad code word)");
      }
      width = ((buf[4] << 8) | buf[3]) & 0x3fff;
      height = ((buf[6] << 8) | buf[5]) & 0x3fff;
      buf += 7;
      left -= 7;
      mb_w = (width + 15) >> 4;
      mb_h = (height + 15) >> 4;
    }
    if (partition_length > left) fail("broken WEBP lossy bitstream (bad partition length)");
    br.init(buf, partition_length);
    buf += partition_length;
    left -= partition_length;
    if (key_frame) {
      br.get_value(1);  // colour space
      br.get_value(1);  // clamping type: libwebp always clamps
    }
    parse_segment_header();
    if (br.eof) fail("broken WEBP lossy bitstream (cannot parse segment header)");
    parse_filter_header();
    if (br.eof) fail("broken WEBP lossy bitstream (cannot parse filter header)");
    parse_partitions(buf, left);
    parse_quant();
    if (!key_frame) fail("broken WEBP lossy bitstream (not a key frame)");
    br.get_value(1);  // update_proba, ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            proba[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                    ? (uint8_t)br.get_value(8)
                                    : kCoeffsProba0[t][b][c][p];
          }
    use_skip_proba = br.get_value(1);
    if (use_skip_proba) skip_p = (int)br.get_value(8);
  }

  void parse_segment_header() {
    use_segment = br.get_value(1);
    if (use_segment) {
      update_map = br.get_value(1);
      if (br.get_value(1)) {  // update data
        absolute_delta = br.get_value(1);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) {
          filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
        }
      }
      if (update_map) {
        for (int s = 0; s < 3; ++s) seg_proba[s] = br.get_value(1) ? (uint8_t)br.get_value(8) : 255;
      }
    } else {
      update_map = false;
    }
  }

  void parse_filter_header() {
    simple = br.get_value(1);
    level = (int)br.get_value(6);
    sharpness = (int)br.get_value(3);
    use_lf_delta = br.get_value(1);
    if (use_lf_delta && br.get_value(1)) {
      for (int i = 0; i < 4; ++i) {
        if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
      }
      for (int i = 0; i < 4; ++i) {
        if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
      }
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
  }

  void parse_partitions(const uint8_t* buf, size_t left) {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + left;
    num_parts_m1 = (1 << br.get_value(2)) - 1;
    const size_t last = (size_t)num_parts_m1;
    if (left < 3 * last) fail("broken WEBP lossy bitstream (cannot parse partitions)");
    const uint8_t* part_start = buf + last * 3;
    size_t size_left = left - last * 3;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last].init(part_start, size_left);
    if (part_start >= buf_end) fail("broken WEBP lossy bitstream (cannot parse partitions)");
  }

  static int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

  void parse_quant() {
    const int base_q0 = (int)br.get_value(7);
    const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q + 0, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x155/100
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void precompute_filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = use_segment ? filter_strength[s] + (absolute_delta ? 0 : level) : level;
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int lvl = base;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  // ---- per-macroblock parsing

  std::vector<uint8_t> intra_t;
  uint8_t intra_l[4];

  void parse_intra_mode(int mb_x, Block& block) {
    uint8_t* top = &intra_t[4 * mb_x];
    uint8_t* left = intra_l;
    if (update_map) {
      block.segment = !br.get_bit(seg_proba[0]) ? (uint8_t)br.get_bit(seg_proba[1])
                                                : (uint8_t)(br.get_bit(seg_proba[2]) + 2);
    } else {
      block.segment = 0;
    }
    if (use_skip_proba) block.skip = (uint8_t)br.get_bit(skip_p);
    block.is_i4x4 = !br.get_bit(145);
    if (!block.is_i4x4) {
      const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                        : (br.get_bit(163) ? V_PRED : DC_PRED);
      block.imodes[0] = (uint8_t)ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br.get_bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
          ymode = -i;
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    block.uvmode = !br.get_bit(142) ? DC_PRED : !br.get_bit(114) ? V_PRED
                                               : br.get_bit(183) ? TM_PRED : H_PRED;
  }

  static int large_value(BoolReader& b, const uint8_t* p) {
    int v;
    if (!b.get_bit(p[3])) {
      v = !b.get_bit(p[4]) ? 2 : 3 + b.get_bit(p[5]);
    } else if (!b.get_bit(p[6])) {
      if (!b.get_bit(p[7])) {
        v = 5 + b.get_bit(159);
      } else {
        v = 7 + 2 * b.get_bit(165);
        v += b.get_bit(145);
      }
    } else {
      const int bit1 = b.get_bit(p[8]);
      const int bit0 = b.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.get_bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // the position of the last non-zero coefficient plus one
  int get_coeffs(BoolReader& b, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!b.get_bit(p[0])) return n;
      while (!b.get_bit(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*p_ctx)[11] = proba[type][kBands[n + 1]];
      int v;
      if (!b.get_bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = large_value(b, p);
        p = p_ctx[2];
      }
      out[kZigzag[n]] = (int16_t)(b.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // libwebp's ParseResiduals: the coefficients, the contexts, and whether
  // the macroblock has no non-zero coefficient at all
  bool parse_residuals(MB& mb, MB& left_mb, const Block& block, BoolReader& tb, int16_t* coeffs,
                       int* codes) {
    const Quant& q = dqm[block.segment];
    int16_t* dst = coeffs;
    std::memset(dst, 0, 384 * sizeof(*dst));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left_mb.nz_dc;
      const int nz = get_coeffs(tb, 1, ctx, q.y2, 0, dc);
      mb.nz_dc = left_mb.nz_dc = (nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb.nz & 0x0f, lnz = left_mb.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tb, ac_type, ctx, q.y1, first, dst);
        l = (nz > first);
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        *codes++ = (int)(nz_coeffs & 3);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = (uint8_t)(mb.nz >> (4 + ch));
      lnz = (uint8_t)(left_mb.nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(tb, 2, ctx, q.uv, 0, dst);
          l = (nz > 0);
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          *codes++ = (int)(nz_coeffs & 3);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (uint32_t)(tnz << 4) << ch;
      out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
    }
    mb.nz = (uint8_t)out_t_nz;
    left_mb.nz = (uint8_t)out_l_nz;
    return !(non_zero_y | non_zero_uv);
  }

  // ---- reconstruction (libwebp's ReconstructRow, one macroblock at a time)

  uint8_t yuv_b[YUV_SIZE];
  struct TopSamples {
    uint8_t y[16], u[8], v[8];
  };
  std::vector<TopSamples> yuv_t;

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? DC_NOTOP : B_DC_PRED;
    }
    return mode;
  }

  void begin_row(int mb_y) {
    uint8_t* y_dst = yuv_b + Y_OFF;
    uint8_t* u_dst = yuv_b + U_OFF;
    uint8_t* v_dst = yuv_b + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
  }

  void reconstruct(int mb_x, int mb_y, const Block& block, const int16_t* coeffs,
                   const int* codes) {
    uint8_t* y_dst = yuv_b + Y_OFF;
    uint8_t* u_dst = yuv_b + U_OFF;
    uint8_t* v_dst = yuv_b + V_OFF;
    if (mb_x > 0) {  // rotate in the left samples
      for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    TopSamples* top = &yuv_t[mb_x];
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, top[0].y, 16);
      std::memcpy(u_dst - BPS, top[0].u, 8);
      std::memcpy(v_dst - BPS, top[0].v, 8);
    }
    if (block.is_i4x4) {
      uint8_t* top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w - 1) {
          std::memset(top_right, top[0].y[15], 4);
        } else {
          std::memcpy(top_right, top[1].y, 4);
        }
      }
      for (int r = 1; r < 4; ++r) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        if ((fault & kTopRightFromCurrent) && (n & 3) == 3 && n > 3) {
          std::memset(dst - BPS + 4, dst[-BPS + 3], 4);
        }
        predict4(dst, block.imodes[n]);
        add_block(codes[n], coeffs + n * 16, dst);
      }
    } else {
      predict16(y_dst, check_mode(mb_x, mb_y, block.imodes[0]));
      for (int n = 0; n < 16; ++n) {
        add_block(codes[n], coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
    }
    const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
    predict8(u_dst, uv_mode);
    predict8(v_dst, uv_mode);
    add_uv_blocks(codes + 16, coeffs + 16 * 16, u_dst);
    add_uv_blocks(codes + 20, coeffs + 20 * 16, v_dst);
    if (mb_y < mb_h - 1) {
      std::memcpy(top[0].y, y_dst + 15 * BPS, 16);
      std::memcpy(top[0].u, u_dst + 7 * BPS, 8);
      std::memcpy(top[0].v, v_dst + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; ++j) {
      std::memcpy(&Y[(size_t)(mb_y * 16 + j) * ystride + mb_x * 16], y_dst + j * BPS, 16);
    }
    for (int j = 0; j < 8; ++j) {
      std::memcpy(&U[(size_t)(mb_y * 8 + j) * uvstride + mb_x * 8], u_dst + j * BPS, 8);
      std::memcpy(&V[(size_t)(mb_y * 8 + j) * uvstride + mb_x * 8], v_dst + j * BPS, 8);
    }
  }

  // ---- the frame

  void decode_frame() {
    parse_headers();
    if (width == 0 || height == 0) fail("broken WEBP lossy bitstream (empty frame)");
    precompute_filter_strengths();
    ystride = mb_w * 16;
    uvstride = mb_w * 8;
    Y.assign((size_t)ystride * mb_h * 16, 0);
    U.assign((size_t)uvstride * mb_h * 8, 0);
    V.assign((size_t)uvstride * mb_h * 8, 0);
    intra_t.assign((size_t)4 * mb_w, B_DC_PRED);
    yuv_t.assign(mb_w, TopSamples());
    std::vector<MB> mb_info(mb_w + 1);  // [0] is the left context
    std::vector<Block> blocks(mb_w);
    std::vector<FInfo> finfo((size_t)mb_w * mb_h);
    std::memset(yuv_b, 0, sizeof(yuv_b));
    int16_t coeffs[384];
    int codes[24];
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      BoolReader& tb = parts[mb_y & num_parts_m1];
      std::memset(intra_l, B_DC_PRED, sizeof(intra_l));
      mb_info[0] = MB();
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(mb_x, blocks[mb_x]);
      if (br.eof) fail("broken WEBP lossy bitstream (premature end of partition 0)");
      begin_row(mb_y);
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        Block& block = blocks[mb_x];
        MB& mb = mb_info[mb_x + 1];
        MB& left = mb_info[0];
        bool skip = use_skip_proba ? block.skip : false;
        if (!skip) {
          skip = parse_residuals(mb, left, block, tb, coeffs, codes);
        } else {
          left.nz = mb.nz = 0;
          if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
          std::memset(codes, 0, sizeof(codes));
        }
        if (filter_type > 0) {
          FInfo f = fstrengths[block.segment][block.is_i4x4];
          f.inner = f.inner || !skip;
          finfo[(size_t)mb_y * mb_w + mb_x] = f;
        }
        if (tb.eof) fail("broken WEBP lossy bitstream (premature end of file)");
        reconstruct(mb_x, mb_y, block, coeffs, codes);
      }
    }
    if (filter_type > 0 && !(fault & kNoLoopFilter)) {
      for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y, finfo[(size_t)mb_y * mb_w + mb_x]);
      }
    }
  }

  void filter_mb(int mb_x, int mb_y, const FInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = &Y[(size_t)mb_y * 16 * ystride + mb_x * 16];
    if (filter_type == 1) {
      if (mb_x > 0) simple_filter(y, 1, ystride, limit + 4);
      if (f.inner) {
        for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k, 1, ystride, limit);
      }
      if (mb_y > 0) simple_filter(y, ystride, 1, limit + 4);
      if (f.inner) {
        for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k * ystride, ystride, 1, limit);
      }
      return;
    }
    uint8_t* u = &U[(size_t)mb_y * 8 * uvstride + mb_x * 8];
    uint8_t* v = &V[(size_t)mb_y * 8 * uvstride + mb_x * 8];
    const int il = f.ilevel, ht = f.hev;
    if (mb_x > 0) {
      filter_loop(y, 1, ystride, 16, limit + 4, il, ht, true);
      filter_loop(u, 1, uvstride, 8, limit + 4, il, ht, true);
      filter_loop(v, 1, uvstride, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k < 4; ++k) filter_loop(y + 4 * k, 1, ystride, 16, limit, il, ht, false);
      filter_loop(u + 4, 1, uvstride, 8, limit, il, ht, false);
      filter_loop(v + 4, 1, uvstride, 8, limit, il, ht, false);
    }
    if (mb_y > 0) {
      filter_loop(y, ystride, 1, 16, limit + 4, il, ht, true);
      filter_loop(u, uvstride, 1, 8, limit + 4, il, ht, true);
      filter_loop(v, uvstride, 1, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k < 4; ++k) {
        filter_loop(y + 4 * k * ystride, ystride, 1, 16, limit, il, ht, false);
      }
      filter_loop(u + 4 * uvstride, uvstride, 1, 8, limit, il, ht, false);
      filter_loop(v + 4 * uvstride, uvstride, 1, 8, limit, il, ht, false);
    }
  }
};

// ------------------------------------------------------------ YUV -> RGB

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }

inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb, bool float_yuv) {
  if (float_yuv) {
    const double yy = 1.164 * (y - 16);
    rgb[0] = clip8((int)std::lround(yy + 1.596 * (v - 128)));
    rgb[1] = clip8((int)std::lround(yy - 0.391 * (u - 128) - 0.813 * (v - 128)));
    rgb[2] = clip8((int)std::lround(yy + 2.018 * (u - 128)));
    return;
  }
  rgb[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One output row of libwebp's fancy upsampler: ``near`` the chroma row
// nearer to it, ``far`` the other (the same row at the picture's top and,
// for an even height, its bottom).
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu,
                  const uint8_t* fv, int len, int fault, uint8_t* out) {
  const bool float_yuv = (fault & kFloatYuv) != 0;
  auto px = [&](int x, int u, int v) { yuv_to_rgb(y[x], u, v, out + 4 * x, float_yuv); };
  if (fault & kBoxUpsample) {
    for (int x = 0; x < len; ++x) px(x, nu[x >> 1], nv[x >> 1]);
    return;
  }
  const bool single = (fault & kSingleRoundUpsample) != 0;
  // per chroma plane: the values for output columns 2x-1 and 2x
  auto pair = [&](const uint8_t* n, const uint8_t* f, int x, int* odd, int* even) {
    const int tl = n[x - 1], t = n[x], l = f[x - 1], c = f[x];
    if (single) {  // libjpeg-turbo's h2v2 fancy upsampling: bias 7 at odd columns
      *odd = (9 * tl + 3 * t + 3 * l + c + 7) >> 4;
      *even = (9 * t + 3 * tl + 3 * c + l + 8) >> 4;
      return;
    }
    const int avg = tl + t + l + c + 8;
    const int diag_12 = (avg + 2 * (t + l)) >> 3;
    const int diag_03 = (avg + 2 * (tl + c)) >> 3;
    *odd = (diag_12 + tl) >> 1;
    *even = (diag_03 + t) >> 1;
  };
  px(0, (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    int uo, ue, vo, ve;
    pair(nu, fu, x, &uo, &ue);
    pair(nv, fv, x, &vo, &ve);
    px(2 * x - 1, uo, vo);
    px(2 * x, ue, ve);
  }
  if (!(len & 1)) {
    const int k = last_pair;
    px(len - 1, (3 * nu[k] + fu[k] + 2) >> 2, (3 * nv[k] + fv[k] + 2) >> 2);
  }
}

void decode_vp8(const uint8_t* data, size_t n, int width, int height, int fault, uint8_t* out) {
  Decoder dec(data, n, fault);
  dec.decode_frame();
  if (dec.width != width || dec.height != height) {
    fail("broken WEBP lossy bitstream (size differs from the container's)");
  }
  for (int r = 0; r < height; ++r) {
    // row 0 and an even height's last row take one chroma row; the others
    // pair up as (2k - 1, 2k) between chroma rows k - 1 and k
    int nr = r >> 1, fr = nr;
    if (r & 1) {
      nr = (r - 1) >> 1;
      fr = r + 1 < height ? nr + 1 : nr;
    } else if (r > 0) {
      fr = nr - 1;
    }
    const size_t ny = (size_t)r * dec.ystride;
    const size_t nc = (size_t)nr * dec.uvstride, fc = (size_t)fr * dec.uvstride;
    upsample_row(&dec.Y[ny], &dec.U[nc], &dec.V[nc], &dec.U[fc], &dec.V[fc], width, fault,
                 out + (size_t)r * width * 4);
    for (int x = 0; x < width; ++x) out[((size_t)r * width + x) * 4 + 3] = 255;
  }
}

int report(const std::exception& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", e.what());
  return -1;
}

}  // namespace

extern "C" {

// Decode a VP8 key frame (a "VP8 " chunk's payload with its pad byte) of
// width x height into height x width x 4 RGBA bytes (alpha 255).
int cpt_webp_lossy(const uint8_t* data, long n, int width, int height, int fault, uint8_t* out,
                   char* err, int errlen) {
  try {
    decode_vp8(data, (size_t)n, width, height, fault, out);
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
