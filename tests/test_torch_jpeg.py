"""The JPEG kinds and failure modes of the port's image codec
(``cpt_tpu_torch/utils/image_codec``, host C++ in ``csrc/image_codec.cpp``)
that Pillow 12.1.0 reads through libjpeg-turbo 3.1.3 beyond its own
writer's files, against Pillow on the CPU: arithmetic-coded JPEG
(sequential and progressive, DAC conditioning, restart markers, the
65536-byte reads Pillow feeds a decoder that cannot suspend), lossless JPEG
(predictors 1-7, the point transform, restarts, subsampled components, the
colour rules of a lossless file), progressive files whose scans leave
coefficients unrefined (block smoothing), the islow IDCT's SSE2 / AVX2
arithmetic on out-of-range coefficients, and damaged files, which decode
equal or raise exactly where Pillow raises. The arithmetic and lossless
files come from libjpeg-turbo's own compressor through ``ctypes`` (the
fixture script's ``libjpeg_write``) and its lossless writer; every
expectation is Pillow's decode here."""
from __future__ import annotations

import importlib.util
import io
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

import chip_smoke as cs
from cpt_tpu_torch.utils import image_codec as ic
from test_torch_watchdog import guards

guard_module, guard_case = guards(240)


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", cs.CODEC_DIR / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mf = _fixture_script()
# make_fixtures.jpeg_fixtures' files
NEW_FIXTURES = [p.name for p in cs.codec_fixture_files() if p.suffix == ".jpg"
                and p.name.startswith(("arith_", "lossless_", "smooth_", "damage_"))]


def pillow(data: bytes, mode: str = "RGB"):
    """Pillow's ``convert(mode)`` as an array, or None where it raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(Image.open(io.BytesIO(data)).convert(mode))
        except Exception:      # noqa: BLE001 - any raise is a refusal
            return None


def codec(data: bytes, mode: str = "RGB"):
    """``decode(data, mode)``, or None where it raises ImageCodecError."""
    try:
        return ic.decode(data, mode)
    except ic.ImageCodecError:
        return None


def assert_as_pillow(data: bytes, modes=("RGB", "L"), what="") -> bool:
    """``decode`` equals Pillow's in each mode or raises where Pillow
    raises; ``image_size`` equals Image.open's size or raises where it
    raises. Returns whether Pillow decoded the file."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            size = Image.open(io.BytesIO(data)).size
        except Exception:      # noqa: BLE001
            size = None
    if size is None:
        with pytest.raises(ic.ImageCodecError):
            ic.image_size(data)
    else:
        assert ic.image_size(data) == size, what
    decoded = False
    for mode in modes:
        want, got = pillow(data, mode), codec(data, mode)
        assert (want is None) == (got is None), (what, mode, want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {mode}")
            decoded = True
    return decoded


# the frame marker each new fixture's name promises
FRAME_OF = {"arith_progressive": 0xCA, "smooth_480x640": 0xCA, "arith_": 0xC9,
            "lossless_": 0xC3, "smooth_": 0xC2, "damage_progressive": 0xC2}


def test_new_fixtures_are_jpeg_fixtures():
    assert sorted(NEW_FIXTURES) == sorted(mf.jpeg_fixtures())


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_fixture_is_of_its_kind_and_pillows(name):
    """Each arithmetic, lossless, unrefined-progressive and damage-source
    fixture has the frame its name says (SOF9 / SOF10 / SOF3 / SOF2, else
    baseline), its RGB and L and size equal Pillow's, and an unrefined one
    is smoothed (its decode without smoothing differs)."""
    data = (cs.CODEC_DIR / name).read_bytes()
    frames = [m for _, m in mf.jpeg_segments(data) if 0xC0 <= m <= 0xCF
              and m not in (0xC4, 0xCC)]
    want = next((f for k, f in FRAME_OF.items() if name.startswith(k)), 0xC0)
    assert frames == [want], (name, [hex(f) for f in frames])
    assert assert_as_pillow(data, what=name)
    if name.startswith("smooth_"):
        assert not np.array_equal(
            ic._decode(data, "RGB", ic.FAULTS["no_block_smoothing"]), ic.decode(data))


@pytest.mark.parametrize("source", cs.JPEG_DAMAGE_SOURCES)
def test_damaged_files_fail_where_pillow_fails(source):
    """Every file of the source's damaged corpus (``jpeg_damaged``: 20
    truncations, flips at every 3rd byte): ``image_size`` raises exactly
    where Image.open raises, ``decode`` exactly where Pillow's load raises,
    and decodes equal Pillow's otherwise; the corpus's digest is
    CODEC_DIGESTS' "damaged:" entry."""
    seed = cs.JPEG_DAMAGE_SOURCES.index(source)
    data = (cs.CODEC_DIR / source).read_bytes()
    read = 0
    for i, d in enumerate(cs.jpeg_damaged(data, seed)):
        read += assert_as_pillow(d, ("RGB",), f"{source} #{i}")
    assert read > 100
    want = cs.damage_digest(pillow(d) for d in cs.jpeg_damaged(data, seed))
    assert want == cs.CODEC_DIGESTS[f"damaged:{source}"]


def coefficient_jpeg(blocks: np.ndarray, quant: np.ndarray) -> bytes:
    """A grey extended-sequential JPEG (SOF1) whose 8x8 blocks (one row of
    them) hold ``blocks``' quantised coefficients (natural order; DC
    differences and AC values of up to 15 bits) under the 16-bit table
    ``quant``. Its Huffman tables hold every symbol: DC sizes 0-15 at 5
    bits, AC symbols 0-254 at 8 bits and 255 at 9."""
    nb = len(blocks)
    out = bytearray(b"\xff\xd8")

    def seg(marker: int, body: bytes) -> None:
        out.extend(struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body)

    seg(0xDB, b"\x10" + struct.pack(">64H", *np.asarray(quant).ravel()[mf.ZIGZAG]))
    seg(0xC1, struct.pack(">BHHB", 8, 8, 8 * nb, 1) + b"\x01\x11\x00")
    dc_bits = [0, 0, 0, 0, 16] + [0] * 11
    ac_bits = [0] * 7 + [255, 1] + [0] * 7
    seg(0xC4, bytes([0x00] + dc_bits) + bytes(range(16)))
    seg(0xC4, bytes([0x10] + ac_bits) + bytes(range(256)))
    seg(0xDA, b"\x01\x01\x00\x00\x3f\x00")
    dc_codes = mf.huffman_codes((dc_bits, list(range(16))))
    ac_codes = mf.huffman_codes((ac_bits, list(range(256))))
    acc, nacc = 0, 0

    def put(code: int, length: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << length) | code, nacc + length
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 255
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nacc -= 8

    def value(v: int) -> None:
        size = abs(v).bit_length()
        if size:
            put(v if v >= 0 else v + (1 << size) - 1, size)

    pred = 0
    for blk in blocks:
        zz = [int(v) for v in np.asarray(blk).ravel()[mf.ZIGZAG]]
        diff = zz[0] - pred
        pred = zz[0]
        put(*dc_codes[abs(diff).bit_length()])
        value(diff)
        run = 0
        for v in zz[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                put(*ac_codes[0xF0])
                run -= 16
            put(*ac_codes[run * 16 + abs(v).bit_length()])
            value(v)
            run = 0
        if run:
            put(*ac_codes[0x00])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)
    out += b"\xff\xd9"
    return bytes(out)


@pytest.mark.parametrize("chunk", range(4))
def test_idct_arithmetic_is_pillows(chunk):
    """Blocks of out-of-range coefficients under 16-bit quantisers (products
    past 16 and 32 bits; blocks whose AC rows are all zero, whose columns
    are, and full ones): the islow IDCT's output equals Pillow's on x86-64,
    the SSE2 / AVX2 code's 16-bit dequantisation, sums and saturation, where
    jidctint.c's C arithmetic (the c_idct fault) gives other pixels."""
    rng = np.random.RandomState(3000 + chunk)
    parted = 0
    for trial in range(6):
        nb = 48
        top = [1, 64, 1024, 32767][trial % 4]
        blocks = rng.randint(-top, top + 1, (nb, 8, 8))
        blocks[:, 0, 0] = rng.randint(-16383, 16384, nb) // (8 if trial % 2 else 1)
        blocks[0::3, 1:, :] = 0                      # DC row only
        blocks[1::3, :, 1:] = 0                      # first column only
        blocks[2::6, 1:, 1:] *= rng.rand(7, 7) < 0.1
        quant = rng.randint(1, [2, 256, 4096, 65536][(trial + chunk) % 4], (8, 8))
        data = coefficient_jpeg(blocks, quant)
        want = pillow(data, "L")
        assert want is not None
        np.testing.assert_array_equal(ic.decode(data, "L"), want)
        parted += not np.array_equal(ic._decode(data, "L", ic.FAULTS["c_idct"]), want)
    assert parted


def arith_or_lossless_cases(chunk: int, n: int = 10):
    """Seeded (array, libjpeg_write options) pairs: sizes 1-70, quality
    1-100, arithmetic sequential or progressive (4:2:0, 4:4:4, grey, CMYK;
    DAC conditioning, restart intervals) or lossless (predictor, point
    transform, restart rows; grey or RGB)."""
    rng = np.random.RandomState(4000 + chunk)
    for i in range(n):
        h, w = (int(v) for v in rng.randint(1, 71, 2))
        img = cs.codec_photo(int(rng.randint(1 << 30)), h, w)
        if i % 3 == 2:
            kw = {"lossless": (int(rng.randint(1, 8)), int(rng.randint(0, 4))),
                  "restart_rows": int(rng.randint(0, 3))}
            yield (img if rng.rand() < 0.5 else img[..., 1]), kw
            continue
        kw = {"arith": True, "quality": int(rng.randint(1, 101)),
              "progressive": bool(i % 3 == 1),
              "restart_interval": int(rng.randint(0, 4)) if rng.rand() < 0.4 else 0}
        if rng.rand() < 0.5:
            kw["dac"] = [(int(lo), int(lo + rng.randint(0, 16 - lo)), int(rng.randint(0, 64)))
                         for lo in rng.randint(0, 16, 2)]
        kind = rng.randint(4)
        if kind == 1:
            kw["sampling"] = ((1, 1),) * 3
        elif kind == 2:
            img = img[..., 0]
        elif kind == 3:
            img = np.asarray(Image.fromarray(img).convert("CMYK"))
        yield img, kw


@pytest.mark.parametrize("chunk", range(6))
def test_arithmetic_and_lossless_decode_is_pillows(chunk):
    """Seeded arithmetic-coded and lossless files from libjpeg-turbo's
    compressor: RGB and L equal Pillow's."""
    for img, kw in arith_or_lossless_cases(chunk):
        assert assert_as_pillow(mf.libjpeg_write(img, **kw),
                                what=f"{img.shape} {kw}")


@pytest.mark.parametrize("kind", ["lossless", "arithmetic", "huffman",
                                  "lossless_two_scans"])
def test_multi_scan_files_are_pillows(kind):
    """Sequential files of several scans (libjpeg-turbo's compressor under a
    scan script): lossless with one component a scan (each scan's rows
    start with the first-row rule) or two and one, arithmetic and Huffman
    with non-interleaved components, with restart intervals."""
    rng = np.random.RandomState(["lossless", "arithmetic", "huffman",
                                 "lossless_two_scans"].index(kind))
    for _ in range(4):
        h, w = (int(v) for v in rng.randint(3, 60, 2))
        img = cs.codec_photo(int(rng.randint(1 << 30)), h, w)
        psv, pt = int(rng.randint(1, 8)), int(rng.randint(0, 3))
        if kind == "lossless":
            kw = {"lossless": (psv, pt), "restart_rows": int(rng.randint(0, 3)),
                  "scans": [([c], psv, 0, 0, pt) for c in range(3)]}
        elif kind == "lossless_two_scans":
            kw = {"lossless": (psv, pt), "restart_rows": 1,
                  "scans": [([0, 1], psv, 0, 0, pt), ([2], psv, 0, 0, pt)]}
        else:
            kw = {"arith": kind == "arithmetic",
                  "restart_interval": int(rng.randint(0, 3)),
                  "scans": [([0], 0, 63, 0, 0), ([1, 2], 0, 63, 0, 0)]}
        data = mf.libjpeg_write(img, **kw)
        assert sum(m == 0xDA for _, m in mf.jpeg_segments(data)) == len(kw["scans"])
        assert assert_as_pillow(data, what=f"{img.shape} {kw}")


@pytest.mark.parametrize("chunk", range(3))
def test_unrefined_progressive_files_are_smoothed_as_pillow(chunk):
    """Progressive files (Pillow's and libjpeg-turbo's arithmetic ones,
    4:2:0, 4:4:4 and grey) with 1 up to all but one of their scans dropped:
    libjpeg-turbo's block smoothing (5x5 DC neighbourhoods, DC
    interpolation while no AC bits are in) gives Pillow's pixels, and
    skipping it (no_block_smoothing) other ones."""
    rng = np.random.RandomState(5000 + chunk)
    smoothed = 0
    for i in range(4):
        h, w = (int(v) for v in rng.randint(2, 90, 2))
        img = cs.codec_photo(int(rng.randint(1 << 30)), h, w)
        q = int(rng.randint(5, 100))
        data = (mf.libjpeg_write(img, quality=q, arith=True, progressive=True)
                if i % 2 else mf.pillow_jpeg(
                    img if i % 4 != 2 else img[..., 0], quality=q, progressive=True,
                    **({"subsampling": 0} if i == 3 else {})))
        scans = sum(m == 0xDA for _, m in mf.jpeg_segments(data))
        for k in range(1, scans):
            dropped = mf.drop_scans(data, k)
            assert assert_as_pillow(dropped, what=f"{img.shape} q{q} -{k}")
            smoothed += not np.array_equal(
                ic._decode(dropped, "RGB", ic.FAULTS["no_block_smoothing"]),
                pillow(dropped))
    assert smoothed


def sof_relabelled(code: int) -> bytes:
    """Pillow's baseline file with its SOF0 marker relabelled ``code``."""
    data = bytearray(mf.pillow_jpeg(cs.codec_photo(55, 24, 32)))
    i = data.find(b"\xff\xc0")
    data[i + 1] = code
    return bytes(data)


@pytest.mark.parametrize("case", ["arithmetic", "lossless"])
def test_relabelled_frames_follow_pillow(case):
    """A baseline file relabelled SOF9 (its Huffman data read as arithmetic
    code: noise, which Pillow decodes too) or SOF3 (a lossless scan header
    with Ss 0, which libjpeg refuses): ``decode`` equals Pillow's, or raises
    where Pillow raises."""
    data = sof_relabelled(0xC9 if case == "arithmetic" else 0xC3)
    assert assert_as_pillow(data) == (case == "arithmetic")


def test_arithmetic_data_past_pillows_reads():
    """Pillow feeds libjpeg 65536 bytes a call and libjpeg's arithmetic
    decoder cannot suspend: an arithmetic scan whose data crosses what has
    been fed raises in Pillow and in ``decode`` alike, while one that starts
    after a suspension in the marker reader (a long COM segment before it)
    decodes. Huffman files of the same shape decode either way."""
    img = cs.codec_photo(90, 64, 80)
    results = set()
    for kw in ({"arith": True}, {"arith": True, "progressive": True},
               {"arith": True, "restart_interval": 4}, {}):
        base = mf.libjpeg_write(img, **kw)
        for pad in (65536 - len(base) - 300, 65536 - len(base) + 10,
                    65536 - 150, 65536 + 40, 131072 - 700):
            com = b""
            while pad > 0:
                k = min(pad, 65533)
                com += b"\xff\xfe" + struct.pack(">H", k + 2) + b"x" * k
                pad -= k + 4
            decoded = assert_as_pillow(base[:2] + com + base[2:], ("RGB",), f"{kw}")
            results.add((bool(kw), decoded))
    assert results == {(True, True), (True, False), (False, True)}


def test_lossless_colour_rules_are_libjpegs():
    """A lossless file's colour space: RGB without a marker whatever its
    ids (the fixture lossless_ids123.jpg), and no lossy conversion: a
    lossless YCbCr (JFIF) file raises in Pillow and in ``decode``."""
    rgb = mf.without_segments(mf.libjpeg_write(cs.codec_photo(91, 20, 28),
                                               lossless=(1, 0)), 0xEE)
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    data = rgb[:2] + jfif + rgb[2:]
    assert pillow(data) is None and codec(data) is None
    assert pillow(rgb) is not None
    data = (cs.CODEC_DIR / "lossless_ids123.jpg").read_bytes()
    assert b"\xff\xee" not in data and b"\xff\xe0" not in data
    np.testing.assert_array_equal(ic.decode(data), pillow(data))


@pytest.mark.parametrize("fault,kind", [("c_idct", "damaged:"),
                                        ("arith_default_conditioning", "arith_dac"),
                                        ("lossless_left_predictor", "lossless_"),
                                        ("no_block_smoothing", "smooth_")])
def test_named_jpeg_faults_change_their_digests(fault, kind):
    """Each of this decoder's named faults changes a digest of its own
    kind in ``chip_smoke.codec_digests``: the C IDCT arithmetic a damaged
    corpus's, the default conditioning the DAC fixture's, the left
    predictor a lossless fixture's, skipped smoothing an unrefined one's."""
    changed, _ = cs.codec_digests(fault)
    assert [k for k in changed if k.startswith(kind)
            and changed[k] != cs.CODEC_DIGESTS[k]]
