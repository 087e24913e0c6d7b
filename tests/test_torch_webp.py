"""WEBP in the port's image codec (``cpt_tpu_torch/utils/image_codec``:
the RIFF container in Python, the VP8 and VP8L decoders in host C++,
``csrc/webp_vp8.cpp`` and ``csrc/webp_vp8l.cpp``) against Pillow 12.1.0 on
libwebp 1.6.0, the version its rules were taken from: the committed
fixtures and seeded lossy, lossless, alpha and animated files decoded bit
for bit (RGB, L, and RGBA where Pillow opens RGBA), ``image_size``, damaged
files raising where Pillow raises (else decoding equal), the named faults,
the decompression-bomb refusal; and the JAX package's own image sites
(``load_image``, ``img_from_base64``, ``coco_to_tsv``, the server's
handler, ``cpt_predict.main``) beside the port's on ``.webp`` files. The
seeded files come from the fixture script's writers
(``tests/data/codec/make_fixtures.py``: Pillow's ``save``, libwebp's own
encoder through ``ctypes`` for what ``save`` cannot set, a VP8
re-partitioner for 2-8 token partitions, raw filtered ALPH planes and
animations with offsets)."""
from __future__ import annotations

import base64
import dataclasses
import importlib.util
import io
import json
import shutil
import struct
import warnings

import numpy as np
import PIL
import pytest
import torch
from PIL import Image, features

import chip_smoke as cs
import test_torch_image_codec as tic
import test_torch_serve as ts
from cpt_tpu.config import bert as jbert_cfg
from cpt_tpu.data import coco_json as jcoco
from cpt_tpu.data import vg_tsv as jvg_tsv
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector import convert as jdconv
from cpt_tpu.tools import cpt_predict as jcpt_predict
from cpt_tpu.tools import extract_features as jextract
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.data import coco_json, vg_tsv
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.tools import cpt_predict, extract_features
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
WEBP_FIXTURES = [p.name for p in cs.codec_fixture_files() if p.suffix == ".webp"]
WEBP_FAULTS = [f for f in cs.CODEC_FAULTS if cs.CODEC_FAULT_FILES[f] == ".webp"]


def test_libwebp_is_the_version_the_decoders_follow():
    """The decoders reproduce Pillow 12.1.0 on libwebp 1.6.0; another
    version may decode (or fail) otherwise, and this file says so first."""
    assert PIL.__version__ == "12.1.0"
    assert features.version("webp") == "1.6.0"


def pillow_open(data: bytes):
    """(Pillow's image, or None where ``Image.open`` raises)."""
    try:
        return Image.open(io.BytesIO(data))
    except OSError:
        return None


def assert_decodes_as_pillow(data: bytes) -> None:
    """RGB, L, the RGBA / RGB array of Pillow's own mode, and the size."""
    im = Image.open(io.BytesIO(data))
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(ic.decode(data, mode),
                                      np.asarray(im.convert(mode)))
    arr, mode, _ = ic._decode_webp(data, 0)
    assert mode == im.mode
    np.testing.assert_array_equal(arr, np.asarray(im))
    assert ic.image_size(data) == im.size


@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_fixture_rgba_is_pillows(name):
    """Every committed WEBP fixture: the first frame as Pillow opens it
    (mode RGBA with an alpha flag, else RGB; alpha planes decoded, an
    animation's canvas transparent black outside its first frame), RGB
    and L, and the canvas size."""
    assert_decodes_as_pillow((cs.CODEC_DIR / name).read_bytes())


def seeded_rgb(rng, h: int, w: int) -> np.ndarray:
    """Noise, or a photo-like image, as the case's draw says."""
    if rng.rand() < 0.25:
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return cs.codec_photo(int(rng.randint(1 << 30)), h, w)


def seeded_alpha(rng, h: int, w: int) -> np.ndarray:
    kind = rng.randint(3)
    if kind == 0:
        return rng.randint(0, 256, (h, w)).astype(np.uint8)
    if kind == 1:       # a disc, opaque inside
        y, x = np.mgrid[0:h, 0:w]
        return np.where((y - h / 2) ** 2 + (x - w / 2) ** 2 < (min(h, w) / 2.5) ** 2,
                        255, rng.randint(0, 256)).astype(np.uint8)
    return cs.codec_photo(int(rng.randint(1 << 30)), h, w)[..., 0]


def lossy_cases(chunk: int, n: int = 10):
    """Seeded lossy files, sizes 1-160 (1x1 and odd ones among them):
    Pillow's writer at quality 0-100 and methods 0-6, or libwebp's encoder
    with a drawn config (simple or normal filter, strength 0-100,
    sharpness 0-7, 1-4 segments, SNS, auto filter, entropy passes, alpha
    planes raw or lossless under filters 0-2 and alpha qualities that
    quantize them), some with an alpha plane; a third re-coded into 2, 4
    or 8 token partitions."""
    rng = np.random.RandomState(9000 + chunk)
    for i in range(n):
        h, w = (1, 1) if i == 0 else (int(v) for v in rng.randint(1, 161 if i % 4 == 1 else 60, 2))
        img = seeded_rgb(rng, h, w)
        if rng.rand() < 0.35:
            img = np.dstack([img, seeded_alpha(rng, h, w)])
        if rng.rand() < 0.5:
            data = mf.webp(img, quality=int(rng.randint(0, 101)),
                           method=int(rng.randint(0, 7)))
        else:
            cfg = {"quality": float(rng.randint(0, 101)),
                   "method": int(rng.randint(0, 7)),
                   "filter_type": int(rng.randint(0, 2)),
                   "filter_strength": int(rng.randint(0, 101)),
                   "filter_sharpness": int(rng.randint(0, 8)),
                   "segments": int(rng.randint(1, 5)),
                   "sns_strength": int(rng.randint(0, 101)),
                   "autofilter": int(rng.rand() < 0.3),
                   "pass_": int(rng.randint(1, 3)),
                   "alpha_compression": int(rng.randint(0, 2)),
                   "alpha_filtering": int(rng.randint(0, 3)),
                   "alpha_quality": int(rng.choice([100, 100, 60, 10]))}
            data = mf.libwebp_encode(img, **cfg)
        if rng.rand() < 0.35:
            data = mf.webp_partitions(data, int(rng.randint(1, 4)))
        yield data


@pytest.mark.parametrize("chunk", range(6))
def test_lossy_decode_is_pillows(chunk):
    for data in lossy_cases(chunk):
        assert_decodes_as_pillow(data)


def test_repartitioned_frames_keep_their_pixels():
    """The fixture script's re-partitioner changes how a frame is coded,
    not what it decodes to (Pillow's reading): so the partition fixtures
    test the decoder's partitions and nothing else."""
    src = mf.webp(cs.codec_photo(9100, 70, 90), quality=60)
    want = np.asarray(Image.open(io.BytesIO(src)))
    for k in (1, 2, 3):
        data = mf.webp_partitions(src, k)
        assert data != src
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), want)
        np.testing.assert_array_equal(ic.decode(data), want)


def palette_image(rng, h: int, w: int, colours: int) -> np.ndarray:
    pal = rng.randint(0, 256, (colours, 4)).astype(np.uint8)
    pal[:, 3] = np.where(rng.rand(colours) < 0.7, 255, pal[:, 3])
    blobs = np.kron(rng.randint(0, colours, (h // 3 + 1, w // 3 + 1)),
                    np.ones((3, 3), int))[:h, :w]
    return pal[blobs]


def lossless_cases(chunk: int, n: int = 10):
    """Seeded lossless files, sizes 1-120: photos, noise, 2 to 256-colour
    images (colour indexing, 1, 2, 4 and 8 pixels a byte), RGBA with drawn
    alpha; Pillow's writer at efforts (quality) 0-100, methods 0-6, exact
    or not, or libwebp's at near-lossless levels."""
    rng = np.random.RandomState(9200 + chunk)
    for i in range(n):
        h, w = (1, 1) if i == 0 else (int(v) for v in rng.randint(1, 121 if i % 3 == 1 else 50, 2))
        kind = i % 4
        if kind == 0:
            img = seeded_rgb(rng, h, w)
        elif kind == 1:
            img = palette_image(rng, h, w, int(rng.choice([2, 3, 4, 5, 11, 16, 17, 200, 256])))
        else:
            img = np.dstack([seeded_rgb(rng, h, w), seeded_alpha(rng, h, w)])
        if kind == 3:
            yield mf.libwebp_encode(img, lossless=1, quality=float(rng.randint(0, 101)),
                                    method=int(rng.randint(0, 7)),
                                    near_lossless=int(rng.choice([100, 80, 40])),
                                    exact=int(rng.randint(0, 2)))
        else:
            yield mf.webp(img, lossless=True, quality=int(rng.randint(0, 101)),
                          method=int(rng.randint(0, 7)), exact=bool(rng.rand() < 0.5))


@pytest.mark.parametrize("chunk", range(4))
def test_lossless_decode_is_pillows(chunk):
    for data in lossless_cases(chunk):
        assert_decodes_as_pillow(data)


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_raw_alpha_filters(method):
    """A raw ALPH plane under each of libwebp's prediction filters (none,
    horizontal, vertical, gradient), as Pillow reads it, at 1x1 too."""
    rng = np.random.RandomState(9300 + method)
    for h, w in ((1, 1), (1, 9), (13, 1), (37, 51)):
        alpha = seeded_alpha(rng, h, w)
        data = mf.raw_alpha_webp(seeded_rgb(rng, h, w), alpha, method)
        assert_decodes_as_pillow(data)
        np.testing.assert_array_equal(ic._decode_webp(data, 0)[0][..., 3], alpha)


def animation_cases(n: int = 6):
    """Pillow's animated writer (lossy, lossless, mixed, with and without
    alpha) and the fixture script's (first frames off the origin, smaller
    than the canvas)."""
    rng = np.random.RandomState(9400)
    for i in range(n):
        h, w = (int(v) for v in rng.randint(2, 60, 2))
        frames = [seeded_rgb(rng, h, w) for _ in range(3)]
        if i % 2:
            frames = [np.dstack([f, seeded_alpha(rng, h, w)]) for f in frames]
        if i < 3:
            ims = [Image.fromarray(f) for f in frames]
            buf = io.BytesIO()
            ims[0].save(buf, format="WEBP", save_all=True, append_images=ims[1:],
                        duration=[50, 80, 20], lossless=i == 1,
                        allow_mixed=i == 2, quality=70)
            yield buf.getvalue()
        else:
            x, y = (2 * int(v) for v in rng.randint(0, 8, 2))
            canvas = (w + x + int(rng.randint(0, 10)), h + y + int(rng.randint(0, 10)))
            first = (mf.webp(frames[0], lossless=True) if i == 5
                     else mf.webp(frames[0], quality=60))
            yield mf.webp_animation(canvas, [(x, y, first),
                                             (0, 0, mf.webp(frames[1], quality=60))])


def test_animations_first_frame_is_pillows():
    for data in animation_cases():
        assert_decodes_as_pillow(data)


DAMAGE_SOURCES = {
    "lossy": lambda: mf.webp(cs.codec_photo(9500, 40, 56), quality=75),
    "alpha": lambda: mf.webp(np.dstack([cs.codec_photo(9501, 40, 56),
                                        cs.codec_photo(9502, 40, 56)[..., 0]]),
                             quality=75),
    "lossless": lambda: mf.webp(cs.codec_photo(9503, 40, 56), lossless=True),
    "partitions": lambda: mf.webp_partitions(
        mf.webp(cs.codec_photo(9504, 56, 40), quality=75), 2),
    "animation": lambda: mf.webp_animation(
        (70, 50), [(4, 2, mf.webp(np.dstack([cs.codec_photo(9505, 30, 40),
                                             cs.codec_photo(9506, 30, 40)[..., 1]]),
                                  quality=60)),
                   (0, 0, mf.webp(cs.codec_photo(9507, 50, 70), quality=60))]),
}


def damaged(data: bytes, rng):
    """Every 20th truncation point, and byte flips (xor 1, 0x80, 0xff and a
    drawn value) at every 3rd byte."""
    for n in range(0, len(data), max(1, len(data) // 20)):
        yield data[:n]
    for i in range(0, len(data), 3):
        for x in (1, 0x80, 0xFF, int(rng.randint(1, 256))):
            b = bytearray(data)
            b[i] ^= x
            yield bytes(b)


@pytest.mark.parametrize("kind", sorted(DAMAGE_SOURCES))
def test_damaged_files_fail_where_pillow_fails(kind):
    """Truncated and byte-flipped lossy, alpha, lossless, partitioned and
    animated files: ``image_size`` raises ``ImageCodecError`` exactly where
    ``Image.open`` raises, and ``decode`` exactly where Pillow's load
    raises; every file both read decodes equal."""
    rng = np.random.RandomState(sorted(DAMAGE_SOURCES).index(kind))
    for data in damaged(DAMAGE_SOURCES[kind](), rng):
        im = pillow_open(data)
        if im is None:
            with pytest.raises(ic.ImageCodecError):
                ic.image_size(data)
            continue
        assert ic.image_size(data) == im.size
        try:
            want = np.asarray(im.convert("RGB"))
        except OSError:
            with pytest.raises(ic.ImageCodecError):
                ic.decode(data)
            continue
        np.testing.assert_array_equal(ic.decode(data), want)


@pytest.mark.parametrize("fault", WEBP_FAULTS)
def test_named_faults_change_a_webp_decode(fault):
    """Each of the WEBP decoders' named faults changes some fixture's
    pixels (a refusal counts as a change)."""
    changed = []
    for name in WEBP_FIXTURES:
        data = (cs.CODEC_DIR / name).read_bytes()
        try:
            got = ic._decode(data, "RGB", ic.FAULTS[fault])
        except ic.ImageCodecError:
            changed.append(name)
            continue
        if not np.array_equal(got, ic.decode(data)):
            changed.append(name)
    assert changed


def vp8_bomb() -> bytes:
    """A lossy file whose frame header declares 16383 x 16383 (the most
    14 bits hold), some hundred bytes in all."""
    data = bytearray(mf.webp(cs.codec_photo(9600, 16, 16), quality=50))
    at = data.find(b"\x9d\x01\x2a") + 3
    data[at:at + 4] = struct.pack("<HH", 16383, 16383)
    return bytes(data)


def vp8x_bomb() -> bytes:
    """A VP8X canvas of 16384 x 12000 around a lossless frame of the same
    declared size."""
    vp8l = bytearray(dict(mf.riff_chunks(mf.webp(cs.codec_photo(9601, 8, 8),
                                                 lossless=True)))[b"VP8L"])
    bits = int.from_bytes(vp8l[1:5], "little") & ~((1 << 28) - 1)
    vp8l[1:5] = (bits | 16383 | (11999 << 14)).to_bytes(4, "little")
    return mf.riff(mf.vp8x(0, 16384, 12000) + mf.webp_chunk(b"VP8L", bytes(vp8l)))


@pytest.mark.parametrize("make", [vp8_bomb, vp8x_bomb])
def test_webp_decompression_bombs_raise(make):
    """A canvas over twice Pillow's MAX_IMAGE_PIXELS raises before any
    pixel is allocated, in ``decode`` and ``image_size``, as Pillow's
    ``Image.open`` raises ``DecompressionBombError``."""
    data = make()
    assert len(data) < 4096
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    for fn in (ic.decode, ic.image_size):
        with pytest.raises(ic.ImageCodecError, match="decompression bomb"):
            fn(data)


REFUSED = {
    "tiff": (tic.tiff_header, "TIFF"),
    "riff_wave": (lambda: b"RIFF" + struct.pack("<I", 28) + b"WAVEfmt "
                  + bytes(20), "cannot identify"),
    "unknown_vp8_chunk": (lambda: b"RIFF" + struct.pack("<I", 30) + b"WEBPVP8Z"
                          + bytes(22), "cannot identify"),
    "empty_vp8l": (lambda: b"RIFF" + struct.pack("<I", 12) + b"WEBPVP8L"
                   + bytes(4), "WEBP"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_other_riff_and_refused_kinds_raise(case):
    """A TIFF whose first directory holds no entry is a broken TIFF file
    (the message names TIFF); a RIFF that is not WEBP, or a WEBP whose first
    chunk is no VP8 chunk, cannot be identified; an empty lossless chunk is
    a broken WEBP. Pillow raises on each too."""
    make, word = REFUSED[case]
    data = make()
    with pytest.raises(ic.ImageCodecError, match=word):
        ic.decode(data)
    with pytest.raises(OSError):
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# --- the JAX package's image sites on .webp files --------------------------------

PARITY_FILES = ["lossy_q75.webp", "lossy_alpha_q75.webp", "lossless_rgba.webp",
                "odd_481x641_q80.webp", "anim_offset.webp", "palette4_lossless.webp"]


@pytest.mark.parametrize("name", PARITY_FILES)
def test_load_image_matches_jax_on_webp(name):
    """``extract_features.load_image`` (with the 600/1000 resize rule and
    without) equals the JAX tool's on the same WEBP file."""
    path = str(cs.CODEC_DIR / name)
    for rule in ((None, None), (600, 1000)):
        got, hw = extract_features.load_image(path, 640, 1024, *rule)
        want, jhw = jextract.load_image(path, 640, 1024, *rule)
        assert tuple(hw) == tuple(jhw)
        np.testing.assert_array_equal(got, want)


def test_vg_tsv_decode_matches_jax_on_webp():
    """``vg_tsv.img_from_base64`` equals the JAX reader's on base64 WEBP
    bytes."""
    for name in PARITY_FILES:
        b64 = base64.b64encode((cs.CODEC_DIR / name).read_bytes()).decode()
        np.testing.assert_array_equal(vg_tsv.img_from_base64(b64),
                                      jvg_tsv.img_from_base64(b64))


def test_coco_to_tsv_matches_jax_on_webp(tmp_path):
    """``convert_dataset coco``'s converter over a directory of WEBP files
    writes the JAX converter's files byte for byte."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    images, anns = [], []
    for i, name in enumerate(PARITY_FILES[:4]):
        shutil.copy(cs.CODEC_DIR / name, img_dir / f"{i + 1:012d}.webp")
        w, h = ic.image_size(img_dir / f"{i + 1:012d}.webp")
        images.append({"id": i + 1, "file_name": f"{i + 1:012d}.webp",
                       "height": h, "width": w})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1 + i % 2,
                     "bbox": [1.0, 2.0, w / 3, h / 4], "area": w * h / 12,
                     "iscrowd": 0})
    ann = tmp_path / "instances.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": 1, "name": "cat"},
                                              {"id": 2, "name": "dog"}]}))
    coco_json.coco_to_tsv(str(ann), str(img_dir), str(tmp_path / "port"))
    jcoco.coco_to_tsv(str(ann), str(img_dir), str(tmp_path / "jax"))
    port, jax_ = tic.tree_bytes(tmp_path / "port"), tic.tree_bytes(tmp_path / "jax")
    assert port.keys() == jax_.keys() and len(port) >= 5
    for k in port:
        want = jax_[k].replace(str(tmp_path / "jax").encode(),
                               str(tmp_path / "port").encode())
        assert port[k] == want, k


def test_serve_handler_matches_jax_on_webp():
    """A lossy-with-alpha WEBP upload through the port's HTTP handler and
    ``CPTService`` picks the JAX service's box, every score within the
    serve tests' SCORE_ATOL, and equals the port's direct call on Pillow's
    decode of the upload."""
    data = (cs.CODEC_DIR / "lossy_alpha_q75.webp").read_bytes()
    body = json.dumps({"image_b64": base64.b64encode(data).decode(),
                       "caption": "the small thing", "dets": ts.DETS}).encode()
    code, got = ts._request(ts._server(), "/predict", body)
    jcode, want = ts._request(tic._jax_server(), "/predict", body)
    assert code == jcode == 200, (got, want)
    assert got["pred_box"] == want["pred_box"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ts.SCORE_ATOL)
    direct = ts._server().svc.predict(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
        "the small thing", ts.DETS)
    assert got["pred_box"] == direct[0] and got["scores"] == direct[1]


def test_cpt_predict_matches_jax_on_webp(tmp_path):
    """``cpt_predict.main --image x.webp --out y.png`` at the tiny config
    picks the JAX tool's box from one detector and one Oscar checkpoint,
    and its overlay reads back equal to the JAX tool's."""
    jcfg = jdet_cfg.tiny_detector_config()
    det = tmp_path / "det.pth"
    torch.save({"model": {"module." + k: torch.from_numpy(np.asarray(v)) for k, v in
                          jdconv.random_vinvl_state_dict(jcfg, seed=9700).items()}},
               det)
    bcfg = cpt_predict.bert_config(32, 2, cpt_predict.region_feature_dim(
        det_cfg.tiny_detector_config()))
    jbcfg = jbert_cfg.BertConfig(**dataclasses.asdict(bcfg))
    oscar = tmp_path / "pytorch_model.bin"
    torch.save({"module." + k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(jbcfg, seed=9701).items()}, oscar)
    image = str(cs.CODEC_DIR / "lossy_alpha_q75.webp")
    dets = json.dumps([[4, 4, 60, 50], [50, 30, 120, 90], [10, 50, 70, 94]])
    flags = ["--image", image, "--caption", "the thing on the left", "--dets",
             dets, "--tiny", "--dtype", "float32", "--hidden_size", "32",
             "--num_hidden_layers", "2", "--checkpoint", str(det),
             "--oscar_checkpoint", str(oscar)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jcpt_predict.main(flags + ["--out", str(tmp_path / "jax.png"),
                                          "--workdir", str(tmp_path / "jwd")])
    got = cpt_predict.main(flags + ["--device", "cpu", "--out",
                                    str(tmp_path / "port.png"), "--workdir",
                                    str(tmp_path / "pwd")])
    assert [float(v) for v in got] == [float(v) for v in want]
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port.png").convert("RGB")),
        np.asarray(Image.open(tmp_path / "jax.png").convert("RGB")))
