"""The port's grounding server (``cpt_tpu_torch/tools/serve.py``) on the
CPU at tiny sizes: HTTP health, round trip and errors, ``predict`` against
the JAX ``CPTService`` on the same seeded reference-layout weights in f32,
the power-of-two scoring buckets, batched base passes against serial
requests, the resize at scale 1.0, and that a request served on a handler
thread builds no autograd state."""
import base64
import concurrent.futures
import dataclasses
import functools
import io
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cpt_tpu.models.detector import config as jdet_config
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.tools import serve as jserve
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.models.detector import config as det_config
from cpt_tpu_torch.tools import serve
from test_torch_watchdog import guards

guard_module, guard_case = guards(200)

# tiny models in f32: the scores are ratios of two MLM logits, equal to
# summation-order noise
SCORE_ATOL = 1e-4
TINY = ["--tiny", "--port", "0", "--hidden_size", "64", "--num_hidden_layers",
        "2", "--no_warmup", "--dtype", "float32"]
DETS = [[1, 1, 28, 28], [30, 30, 60, 50], [10, 40, 40, 62]]


def _image(seed, h=64, w=64):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _server():
    """The port's tiny server (random weights from seed 0), serving on a
    daemon thread of this process."""
    httpd = serve.serve_forever(serve.build_args().parse_args(
        TINY + ["--device", "cpu"]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@functools.lru_cache(maxsize=None)
def _jax_predictions():
    """The JAX service's answers to the requests of ``test_predict_matches_jax``,
    with the port's seed-0 reference-layout weights loaded into it."""
    svc = jserve.CPTService(jserve.build_args().parse_args(TINY))
    svc.extractor.params = {"params": convert_detector_state_dict(
        random_vinvl_state_dict(svc.dcfg, seed=0), svc.dcfg)}
    svc.oparams = {"params": jconv.params_for_task(jconv.convert_bert_state_dict(
        jconv.random_oscar_state_dict(svc.cfg, seed=0), svc.cfg), "rec_mlm_cpt")}
    return [svc.predict(_image(seed), "the small thing", DETS[:n])
            for seed, n in ((7, 2), (8, 3))]


def _url(httpd, path):
    host, port = httpd.server_address
    return f"http://{host}:{port}{path}"


def _request(httpd, path, body=None):
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(_url(httpd, path), data=body)
    try:
        with opener.open(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png_b64(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_healthz():
    code, obj = _request(_server(), "/healthz")
    assert code == 200 and obj["status"] == "ok" and obj["device"] == "cpu"


def test_predict_roundtrip_matches_direct_call():
    httpd = _server()
    img = _image(3)
    pred, scores = httpd.svc.predict(img, "the red dog", DETS)
    body = json.dumps({"image_b64": _png_b64(img), "caption": "the red dog",
                       "dets": DETS}).encode()
    code, resp = _request(httpd, "/predict", body)
    assert code == 200, resp
    assert resp["pred_box"] == pred and resp["scores"] == scores
    assert pred in [[float(v) for v in d] for d in DETS] and len(scores) == 3
    assert _request(httpd, "/healthz")[1]["requests"] >= 2


def test_errors():
    httpd = _server()
    too_many = [[1, 1, 5, 5]] * (serve.MAX_REQUEST_DETS + 1)
    code, resp = _request(httpd, "/predict", json.dumps({
        "image_b64": _png_b64(_image(1)), "caption": "x",
        "dets": too_many}).encode())
    assert code == 400 and "too many candidate dets" in resp["error"]
    code, resp = _request(httpd, "/predict", b"{not json")
    assert code == 400 and "error" in resp
    code, resp = _request(httpd, "/predict", json.dumps({"caption": "x"}).encode())
    assert code == 400 and "image_b64" in resp["error"]
    assert _request(httpd, "/nope")[0] == 404
    assert _request(httpd, "/nope", b"{}")[0] == 404


def test_predict_matches_jax():
    """The same images, captions, dets and seed-0 weights: the same box and
    every candidate's score within SCORE_ATOL (the JAX service resizes with
    Pillow to the 600-pixel rule and clips to the 64 canvas, as the port)."""
    svc = _server().svc
    for (seed, n), (jbox, jscores) in zip(((7, 2), (8, 3)), _jax_predictions()):
        box, scores = svc.predict(_image(seed), "the small thing", DETS[:n])
        assert box == jbox
        np.testing.assert_allclose(scores, jscores, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("n_copies,n_dets,pin,want", [
    (1, 1, 0, (8, 8)), (8, 8, 0, (8, 8)), (9, 9, 0, (16, 16)),
    (16, 16, 0, (16, 16)), (17, 17, 0, (32, 32)), (40, 40, 0, (64, 50)),
    (128, 128, 0, (128, 50)), (5, 3, 32, (32, 50)), (40, 40, 32, (64, 50))])
def test_score_buckets(n_copies, n_dets, pin, want):
    """(batch, region slots) per request: the JAX server's pow2 buckets."""
    args = serve.build_args().parse_args(TINY + ["--score_batch", str(pin)])
    svc = serve.CPTService.__new__(serve.CPTService)
    svc.args = args
    assert svc.score_shape(n_copies, n_dets) == want


def test_request_scores_in_its_bucket(monkeypatch):
    """A 3-candidate request is scored in one batch of 8 sequences with 8
    region slots."""
    seen = []
    real = serve.iter_eval_batches

    def spy(data, bsz, *a):
        for batch, ex in real(data, bsz, *a):
            seen.append((len(batch.tensors), data.img_seq_len))
            yield batch, ex

    monkeypatch.setattr(serve, "iter_eval_batches", spy)
    _server().svc.predict(_image(5), "a cat", DETS)
    assert seen == [(8, 8)]


def test_base_batch_concurrent_matches_serial(monkeypatch):
    """--base_batch 3 (windowed tiny config: 256 canvas, window 192, halo
    48): 3 requests queued together drain as one batched base pass and
    answer as the same requests served one at a time. A first request
    holds the worker in its host prep until the 3 are queued."""
    svc = serve.CPTService(serve.build_args().parse_args(
        TINY + ["--device", "cpu", "--tiny_canvas", "256", "--windowed",
                "--window", "192", "192", "--halo", "48", "--base_batch", "3",
                "--score_batch", "8"]))
    assert svc.batcher is not None and svc.extractor.windowed
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(0, 256, (256, 256, 3)).astype(np.uint8),
             f"the thing {i}", [[120, 120, 136, 136], [100, 110, 150, 140]])
            for i in range(3)]
    serial = [svc.predict(*r) for r in reqs]
    entered, gate = threading.Event(), threading.Event()
    prepare = svc._prepare

    def gated(img, caption, dets):
        if caption == "gate":
            entered.set()
            assert gate.wait(120)
        return prepare(img, caption, dets)

    monkeypatch.setattr(svc, "_prepare", gated)
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        first = ex.submit(svc.predict, reqs[0][0], "gate", reqs[0][2])
        assert entered.wait(120)
        futs = [ex.submit(svc.predict, *r) for r in reqs]
        for _ in range(6000):
            if svc.batcher.q.qsize() == 3:
                break
            gate.wait(0.02)
        assert svc.batcher.q.qsize() == 3
        gate.set()
        together = [f.result(timeout=120) for f in futs]
        first.result(timeout=120)
    assert list(svc.batcher.stats["drains"]) == [1, 1, 1, 1, 3]
    for (p1, s1), (p2, s2) in zip(serial, together):
        assert p1 == p2
        np.testing.assert_allclose(s2, s1, rtol=0, atol=SCORE_ATOL)


def _canvas(module, n):
    cfg = module.tiny_detector_config()
    return dataclasses.replace(cfg, input=dataclasses.replace(
        cfg.input, pad_h=n, pad_w=n, buckets=((n, n),)))


def test_resize_at_scale_one_is_pillows(monkeypatch):
    """An image whose shorter side is MIN_SIZE_TEST (600) resizes at scale
    1.0: the port keeps it as it is, which is what Pillow's resize returns,
    and the JAX service's ``_resize`` gives the same array. The port needs
    no Pillow for it, nor at scale 2.0, where it equals the JAX service's
    Pillow resize too."""
    from PIL import Image

    svc = serve.CPTService.__new__(serve.CPTService)
    jsvc = jserve.CPTService.__new__(jserve.CPTService)
    svc.dcfg, jsvc.dcfg = _canvas(det_config, 512), _canvas(jdet_config, 512)
    img = _image(2, 600, 800)
    want = np.asarray(Image.fromarray(img).resize((800, 600), Image.BILINEAR))
    jgot, jscale = jsvc._resize(img)
    small = _image(2, 300, 400)
    jsmall, jsmall_scale = jsvc._resize(small)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got, scale = svc._resize(img)
    assert scale == jscale == 1.0
    np.testing.assert_array_equal(want[:512, :512], jgot)
    np.testing.assert_array_equal(got, jgot)
    got, scale = svc._resize(small)           # scale 2.0, no Pillow
    assert scale == jsmall_scale == 2.0
    np.testing.assert_array_equal(got, jsmall)


def test_handler_thread_builds_no_autograd_state():
    """Grad mode is per thread: a request answered on the HTTP server's
    handler thread runs both models under inference mode, so no output
    requires grad and no parameter gets a gradient."""
    svc = _server().svc
    outputs = []

    def hook(_module, _inputs, out):
        outputs.extend(t for t in (out if isinstance(out, tuple) else (out,))
                       if isinstance(t, torch.Tensor))

    handles = [m.register_forward_hook(hook)
               for m in (svc.res.oscar, svc.res.detector.backbone)]
    try:
        code, _ = _request(_server(), "/predict", json.dumps({
            "image_b64": _png_b64(_image(6)), "caption": "the dog",
            "dets": DETS}).encode())
    finally:
        for h in handles:
            h.remove()
    assert code == 200 and len(outputs) >= 2
    assert not any(t.requires_grad for t in outputs)
    assert all(t.is_inference() for t in outputs)
    params = list(svc.res.oscar.parameters()) + list(svc.res.detector.parameters())
    assert any(p.requires_grad for p in params)
    assert all(p.grad is None for p in params)
