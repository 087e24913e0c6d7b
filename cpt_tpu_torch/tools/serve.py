"""Persistent CPT grounding server, the serving surface (port of
``cpt_tpu/tools/serve.py``).

Both stages stay resident on one device (``cpt_predict.Resident``):
stage-1 colored-copy extraction (``engine/extract.Extractor``, windowed
with ``--windowed``) and stage-2 ``REC_MLM_CPT`` color-word scoring. Per
request the host decodes the image, resizes it by the MIN/MAX_SIZE_TEST
rule, writes the stage-1 TSV to a temporary directory and reads it back
for stage 2, as ``cpt_predict.predict`` does. Stage 2 scores in power-of-
two batch and region buckets per request (``CPTService.score_shape``),
which decide the shapes kernels K3 and K4 run at.

Protocol (JSON over HTTP, stdlib only):
  GET  /healthz
      → {"status": "ok", "device": "cuda" | "cpu", "requests": N}
  POST /predict   {"image_b64": <b64 image file bytes>, "caption": str,
                   "dets": [[x1,y1,x2,y2], ...]}   (inclusive xyxy,
                                                    original image coords)
      → {"pred_box": [x1,y1,x2,y2], "scores": [...], "latency_ms": ...}

One worker lock serializes device work; concurrent HTTP connections queue
on it. With ``--base_batch N`` a worker thread instead drains up to N
queued requests and runs their windowed base passes as one batched
backbone call. PyTorch's grad mode is per thread, so every thread that
does device work (a handler's, the batcher's) enters
``torch.inference_mode()`` itself.

Usage:
  python -m cpt_tpu_torch.tools.serve --port 8437 \\
      --checkpoint vinvl_vg_x152c4.pth --oscar_checkpoint pytorch_model.bin \\
      --vocab vocab.txt --windowed
  (without checkpoints the weights are random, drawn from seed 0 as the
  JAX server draws them;
  ``--tiny --device cpu --dtype float32`` serves tiny models on the CPU.)
"""
from __future__ import annotations

import argparse
import base64
import collections
import dataclasses
import json
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from cpt_tpu_torch.data.refcoco import (RefcocoCPTData, det_json_for_stage2,
                                        iter_eval_batches)
from cpt_tpu_torch.engine.extract import refcoco_payload, refcoco_task
from cpt_tpu_torch.engine.scoring import (make_mlm_at_mask_fn,
                                          refcoco_collect_scores, run_mlm_batch)
from cpt_tpu_torch.engine.windowed import WINDOW_LADDER
from cpt_tpu_torch.models.detector.config import (VINVL_X152C4,
                                                  tiny_detector_config)
from cpt_tpu_torch.tools import cpt_predict
from cpt_tpu_torch.tools._common import dtype_of
from cpt_tpu_torch.utils import image_codec
from cpt_tpu_torch.utils.image_ops import resize_bilinear
from cpt_tpu_torch.utils.tsv import tsv_writer

# production region budget per scored sequence (RefcocoCPTData's
# img_seq_len default)
SCORE_IMG_SEQ = 50
# request-size bound: caps the per-request scoring shape and the region
# features uploaded for it; a bigger candidate list is split by the client
MAX_REQUEST_DETS = 128


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--port", type=int, default=8437)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--checkpoint", default=None,
                   help="vinvl_vg_x152c4.pth / Detectron .pkl")
    p.add_argument("--oscar_checkpoint", default=None)
    p.add_argument("--vocab", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--windowed", action="store_true",
                   help="two-level windowed extraction (engine/windowed.py)")
    p.add_argument("--window", nargs=2, type=int, action="append",
                   default=None, metavar=("H", "W"),
                   help="windowed ladder rung(s); repeatable (default: the "
                        "3-rung WINDOW_LADDER, (512, 640) with --tiny)")
    p.add_argument("--halo", type=int, default=160,
                   help="windowed exactness halo (>= 2x early-stage RF)")
    p.add_argument("--base_batch", type=int, default=1,
                   help=">1: run the windowed base passes of up to this many "
                        "queued requests as one backbone call (single "
                        "requests keep batch-1 latency)")
    p.add_argument("--tiny_canvas", type=int, default=None,
                   help="--tiny only: canvas/pad size override")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="float32 runs on the CPU only (the kernels take bf16)")
    p.add_argument("--score_batch", type=int, default=0,
                   help="minimum stage-2 batch (0 = auto: power-of-two "
                        "buckets of each request's candidate and det counts; "
                        "a request always sizes up past it, so no candidate "
                        "is cut). A pin also fixes the region slots at "
                        f"{SCORE_IMG_SEQ}")
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


class CPTService:
    """Both stages resident; ``predict`` is the warm request path."""

    def __init__(self, args):
        self.args = args
        dcfg = tiny_detector_config() if args.tiny else VINVL_X152C4
        if args.tiny and args.tiny_canvas:
            n = args.tiny_canvas
            dcfg = dataclasses.replace(
                dcfg, input=dataclasses.replace(
                    dcfg.input, pad_h=n, pad_w=n, buckets=((n, n),)))
        if args.window:
            window = [tuple(w) for w in args.window]
        else:
            # the production ladder: each request's copies take the
            # smallest rung their paint fits
            window = (512, 640) if args.tiny else WINDOW_LADDER
        self.res = cpt_predict.build_resident(
            args.device, dtype_of(args), args.tiny, args.checkpoint,
            args.oscar_checkpoint, args.vocab, 0, args.hidden_size,
            args.num_hidden_layers, windowed=args.windowed, window=window,
            halo=args.halo, det_cfg=dcfg)
        self.dcfg = dcfg
        self.cfg = self.res.bert_cfg
        self.device = self.res.device
        self.tokenizer = self.res.tokenizer
        self.extractor = self.res.extractor
        self.score_fn = make_mlm_at_mask_fn(self.res.oscar)

        self.lock = threading.Lock()
        self.n_requests = 0
        self.batcher = (_BaseBatcher(self, args.base_batch)
                        if args.base_batch > 1 else None)
        if not args.no_warmup:
            self._warmup()

    def _warmup(self):
        """Run the first requests (the kernels' build, the first use of each
        cuDNN / cuBLAS shape) before serving: a 2-candidate request and a
        10-candidate one, the common size. The JAX server also runs a
        padded batched base pass here, to compile it; eager PyTorch compiles
        nothing per shape, so a batched base pass needs no warm-up."""
        h = w = self.dcfg.input.buckets[0][0]
        img = np.zeros((h, w, 3), np.uint8)
        dets = [[1.0, 1.0, min(32.0, w - 2), min(32.0, h - 2)],
                [2.0, 2.0, min(48.0, w - 2), min(40.0, h - 2)]]
        t0 = time.perf_counter()
        self.predict(img, "the red warmup box", dets)
        rng = np.random.RandomState(0)
        dets16 = [[float(x), float(y), float(x + 24), float(y + 24)]
                  for x, y in zip(rng.randint(1, max(w - 26, 2), 10),
                                  rng.randint(1, max(h - 26, 2), 10))]
        self.predict(img, "the red warmup box", dets16)
        print(f"warmup done in {time.perf_counter() - t0:.1f}s")

    def _resize(self, img: np.ndarray):
        """The reference MIN/MAX_SIZE_TEST rule (extract_features.load_image)
        in memory → (the image resized, clipped to the largest canvas, and
        the scale). Bilinear as Pillow resizes (``utils/image_ops``); at
        scale 1.0 that returns the same pixels, so the image is kept."""
        c = self.dcfg.input
        h, w = img.shape[:2]
        scale = 1.0
        if c.min_size_test:
            scale = c.min_size_test / min(h, w)
            if c.max_size_test and scale * max(h, w) > c.max_size_test:
                scale = c.max_size_test / max(h, w)
        if scale != 1.0:
            img = resize_bilinear(img, (int(round(w * scale)),
                                        int(round(h * scale))))
        return np.ascontiguousarray(img[: c.pad_h, : c.pad_w]), scale

    def score_shape(self, n_copies: int, n_dets: int):
        """(batch size, region slots) of a request's stage-2 batches: the
        smallest power of two ≥ its copies (at least 8 and ``--score_batch``)
        and ≥ its dets (8..SCORE_IMG_SEQ), or SCORE_IMG_SEQ slots under a
        pinned ``--score_batch``. Padding is masked out, so the scores do not
        depend on it; the buckets bound the shapes K3 and K4 run at."""
        bsz = max(self.args.score_batch, 8,
                  1 << max(n_copies - 1, 0).bit_length())
        if self.args.score_batch:
            return bsz, SCORE_IMG_SEQ
        n_dets = min(n_dets, SCORE_IMG_SEQ)
        return bsz, min(SCORE_IMG_SEQ, max(8, 1 << max(n_dets - 1, 0).bit_length()))

    def predict(self, image_rgb: np.ndarray, caption: str, dets_xyxy):
        """→ (pred_box in original coords, per-candidate scores)."""
        if self.batcher is not None:
            return self.batcher.submit(image_rgb, caption, dets_xyxy)
        with self.lock, torch.inference_mode():
            task, scale = self._prepare(image_rgb, caption, dets_xyxy)
            return self._finish(task, caption, scale)

    def _prepare(self, image_rgb: np.ndarray, caption: str, dets_xyxy):
        """Host-side request prep → (ExtractTask, resize scale)."""
        if len(dets_xyxy) > MAX_REQUEST_DETS:
            raise ValueError(
                f"too many candidate dets ({len(dets_xyxy)}); serve at "
                f"most {MAX_REQUEST_DETS} per request")
        img, scale = self._resize(np.asarray(image_rgb, np.uint8))
        dets = np.asarray(dets_xyxy, np.float32) * scale
        return refcoco_task("q0", img, img.shape[:2], dets, caption), scale

    def _finish(self, task, caption: str, scale: float, base=None):
        """Device work for one prepared request (with a windowed base map
        from ``Extractor.base_maps``, or None to compute it here)."""
        with torch.inference_mode():
            feats, labels, scores_det = self.extractor.extract_task(task,
                                                                    base=base)
            objs = self.extractor.boxlists_for(task, feats, labels, scores_det)
            all_scores, all_rects = [], []
            with tempfile.TemporaryDirectory(prefix="cpt_serve_") as wd:
                tsv = os.path.join(wd, "p.tsv")
                ann = os.path.join(wd, "ann.json")
                det = os.path.join(wd, "det.json")
                tsv_writer([["q0", json.dumps(refcoco_payload(task, objs))]],
                           tsv)
                with open(ann, "w") as f:
                    json.dump([{"id": "q0", "caption": caption}], f)
                det_json_for_stage2(tsv, det)
                bsz, img_seq = self.score_shape(task.n_copies,
                                                len(task.det_boxes))
                data = RefcocoCPTData(tsv, ann, det, self.tokenizer,
                                      img_seq_len=img_seq,
                                      img_feat_dim=self.cfg.img_feature_dim)
                try:
                    for batch, _ex in iter_eval_batches(data, bsz):
                        grouped = refcoco_collect_scores(
                            run_mlm_batch(self.score_fn, batch), batch,
                            self.tokenizer)
                        for sc, rc in grouped.values():
                            all_scores.extend(sc)
                            all_rects.extend(rc)
                finally:
                    data.tsv.close()
        best = int(np.argmax(all_scores))
        pred = [float(v) / scale for v in all_rects[best]]
        self.n_requests += 1
        return pred, [float(s) for s in all_scores]


class _BaseBatcher:
    """Micro-batching request queue (``--base_batch``): one worker thread
    drains the requests that queued while the device was busy (up to
    ``max_batch``), runs their windowed base passes as one batched backbone
    call (``Extractor.base_maps``), then finishes each request. An empty
    queue gives batch 1, so a lone request waits for nothing."""

    def __init__(self, svc: CPTService, max_batch: int):
        self.svc = svc
        self.max_batch = max_batch
        self.q: "queue.Queue" = queue.Queue()
        # bounded: a long-lived daemon would otherwise grow these forever
        self.stats = {"drains": collections.deque(maxlen=4096),
                      "base_s": collections.deque(maxlen=4096),
                      "finish_s": collections.deque(maxlen=4096)}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image_rgb, caption, dets_xyxy):
        job = {"args": (image_rgb, caption, dets_xyxy),
               "event": threading.Event(), "result": None, "error": None}
        self.q.put(job)
        job["event"].wait()
        if job["error"] is not None:
            raise job["error"]
        return job["result"]

    def _loop(self):
        with torch.inference_mode():
            while True:
                self._drain()

    def _drain(self):
        jobs = [self.q.get()]
        while len(jobs) < self.max_batch:
            try:
                jobs.append(self.q.get_nowait())
            except queue.Empty:
                break
        prepped = []
        for job in jobs:
            try:
                task, scale = self.svc._prepare(*job["args"])
                prepped.append((job, task, scale))
            except Exception as e:  # noqa: BLE001 — per-job isolation
                job["error"] = e
                job["event"].set()
        if not prepped:
            return
        self.stats["drains"].append(len(prepped))
        t0 = time.perf_counter()
        try:
            # no pad_to: eager PyTorch compiles nothing, so a batch of the
            # queued requests alone is the whole work
            bases = self.svc.extractor.base_maps([t for _, t, _ in prepped])
        except Exception as e:  # noqa: BLE001 — reported to every waiter
            for job, _, _ in prepped:
                job["error"] = e
                job["event"].set()
            return
        self.stats["base_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for (job, task, scale), base in zip(prepped, bases):
            try:
                job["result"] = self.svc._finish(task, job["args"][1], scale,
                                                 base=base)
            except Exception as e:  # noqa: BLE001 — per-job isolation
                job["error"] = e
            finally:
                job["event"].set()
        self.stats["finish_s"].append(time.perf_counter() - t0)


def make_handler(svc: CPTService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "device": svc.device.type,
                                 "requests": svc.n_requests})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                img = image_codec.decode(base64.b64decode(req["image_b64"]))
                t0 = time.perf_counter()
                pred, scores = svc.predict(img, req["caption"], req["dets"])
                self._send(200, {
                    "pred_box": pred, "scores": scores,
                    "latency_ms": round((time.perf_counter() - t0) * 1e3, 1)})
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):  # quiet
            pass

    return Handler


def serve_forever(args, ready_event: "threading.Event | None" = None):
    """The service and its HTTP server, bound but not yet serving (call
    ``serve_forever()`` on it, and ``shutdown()`` to stop)."""
    svc = CPTService(args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(svc))
    print(f"serving on http://{args.host}:{httpd.server_address[1]}")
    if ready_event is not None:
        ready_event.set()
    httpd.svc = svc
    return httpd


def main(argv=None):
    args = build_args().parse_args(argv)
    httpd = serve_forever(args)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()
