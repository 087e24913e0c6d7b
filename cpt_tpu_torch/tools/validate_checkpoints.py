"""Real-checkpoint readiness harness: the first run with trained weights in
one command (port of ``cpt_tpu/tools/validate_checkpoints.py``).

  python -m cpt_tpu_torch.tools.validate_checkpoints \\
      --vinvl models/vinvl_vg_x152c4.pth --oscar models/pytorch_model.bin \\
      --vocab vocab.txt --fixture_dir refcoco_fixture/ --workdir out/

It (1) extracts colored-prompt features for the fixture's queries on the
exact path, (2) with ``--windowed_drift`` extracts them again with
``--windowed --allow-approximate`` and reports the feature drift against
the exact ones, (3) scores zero-shot RefCOCO CPT on the exact features, and
prints one JSON report (accuracy, drift, files).

The fixture is a directory with ``images/``, ``ann.json`` (reference
``finetune_refcoco*.json`` rows: id / file_name / caption / height / bbox)
and ``det.json`` (``{img_id: [{"box": xywh, "class", "conf"}]}``), the
formats ``tools/extract_features.py`` reads.

``--dryrun`` runs the whole chain without weights or data: random state
dicts in the real ``.pth`` / ``.bin`` key layouts are saved with
``torch.save``, a synthetic fixture is written, and both stages run on
tiny configs, so the save → load → convert → forward chain is proven and
only the weights themselves remain. The fixture's jpgs need Pillow;
``--device`` defaults to cuda (``--device cpu --dtype float32`` runs the
plain versions of the kernels).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from cpt_tpu_torch.data.refcoco import det_json_for_stage2
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


def build_args():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--vinvl", default=None, help="vinvl_vg_x152c4.pth")
    p.add_argument("--oscar", default=None, help="Oscar pytorch_model.bin")
    p.add_argument("--vocab", default=None, help="bert vocab.txt")
    p.add_argument("--fixture_dir", default=None,
                   help="images/ + ann.json + det.json")
    p.add_argument("--workdir", required=True)
    p.add_argument("--windowed_drift", action="store_true",
                   help="also extract windowed (allow_approximate) and "
                        "report the drift against the exact features")
    p.add_argument("--n_images", type=int, default=20,
                   help="synthetic fixture size when --fixture_dir is absent")
    p.add_argument("--dryrun", action="store_true",
                   help="tiny configs + random checkpoints in the real "
                        ".pth/.bin layouts (no weights needed)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    return p


def make_synthetic_fixture(root: str, n_images: int, canvas=(384, 512),
                           seed: int = 0) -> None:
    """A synthetic RefCOCO-format fixture: jpg images and the ann / det
    jsons in the reference layouts (``finetune_refcoco.json`` rows; the
    ``test_refcoco_net.py`` det dict). Needs Pillow."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    h, w = canvas
    anns, dets = [], {}
    for i in range(n_images):
        name = f"img_{i:06d}.jpg"
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", name),
                                  quality=92)
        boxes = []
        for b in range(4):
            x1 = float(rng.randint(0, w - 80))
            y1 = float(rng.randint(0, h - 80))
            bw = float(rng.randint(40, 79))
            bh = float(rng.randint(40, 79))
            boxes.append({"box": [x1, y1, bw, bh],
                          "class": ["cat", "dog", "car", "tree"][b],
                          "conf": 0.9})
        dets[str(i)] = boxes
        gt = boxes[i % 4]["box"]
        anns.append({"id": str(i), "file_name": name,
                     "caption": f"the thing number {i}", "height": h,
                     "bbox": gt})
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump(anns, f)
    with open(os.path.join(root, "det.json"), "w") as f:
        json.dump(dets, f)


def make_dryrun_vinvl(workdir: str) -> str:
    """Random tiny-detector weights saved in the real ``.pth`` layout (the
    DetectronCheckpointer ``{"model": state_dict}`` wrapper)."""
    import torch

    from cpt_tpu_torch.models.detector.config import tiny_detector_config
    from cpt_tpu_torch.models.detector.convert import random_vinvl_state_dict

    path = os.path.join(workdir, "vinvl_dryrun.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          random_vinvl_state_dict(
                              tiny_detector_config()).items()}}, path)
    return path


def make_dryrun_oscar(workdir: str, img_feature_dim: int):
    """Random Oscar weights in the real ``.bin`` layout, with the config
    that the stage-2 tool rebuilds from its tiny-size flags."""
    import torch

    from cpt_tpu_torch.config.bert import BertConfig
    from cpt_tpu_torch.utils.convert import random_oscar_state_dict

    bcfg = BertConfig(hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=128,
                      img_feature_dim=img_feature_dim)
    path = os.path.join(workdir, "oscar_dryrun.bin")
    torch.save({k: torch.from_numpy(v) for k, v in
                random_oscar_state_dict(bcfg).items()}, path)
    return path, bcfg


def tsv_feature_dim(tsv_path: str) -> int:
    tsv = TSVFile(tsv_path)
    objs = json.loads(tsv.seek(0)[1])["objects"][0]
    tsv.close()
    return int(decode_feature(objs[0][0]["feature"]).shape[0])


def tsv_feature_drift(exact_tsv: str, approx_tsv: str) -> dict:
    """Feature drift between two extraction TSVs (same queries, same order)."""
    et, at = TSVFile(exact_tsv), TSVFile(approx_tsv)
    if len(et) != len(at):
        raise ValueError(f"{exact_tsv} has {len(et)} rows, {approx_tsv} "
                         f"{len(at)}")
    max_rel, mean_rel, n, agree, labels = 0.0, 0.0, 0, 0, 0
    for i in range(len(et)):
        eobjs = json.loads(et.seek(i)[1])["objects"][0]
        aobjs = json.loads(at.seek(i)[1])["objects"][0]
        for ec, ac in zip(eobjs, aobjs):
            ef = np.stack([decode_feature(b["feature"]) for b in ec])
            af = np.stack([decode_feature(b["feature"]) for b in ac])
            denom = max(np.abs(ef).max(), 1e-9)
            max_rel = max(max_rel, float(np.abs(ef - af).max() / denom))
            mean_rel += float(np.abs(ef - af).mean() / denom)
            n += 1
            agree += sum(e["class"] == a["class"] for e, a in zip(ec, ac))
            labels += len(ec)
    et.close()
    at.close()
    return {"feat_max_rel": max_rel, "feat_mean_rel": mean_rel / max(n, 1),
            "label_agreement": agree / max(labels, 1)}


def main(argv=None) -> dict:
    distributed.initialize_from_env()
    args = build_args().parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)

    if args.dryrun:
        args.vinvl = make_dryrun_vinvl(args.workdir)
    if args.fixture_dir is None:
        args.fixture_dir = os.path.join(args.workdir, "fixture")
        if not os.path.exists(os.path.join(args.fixture_dir, "ann.json")):
            canvas = (128, 128) if args.dryrun else (384, 512)
            make_synthetic_fixture(args.fixture_dir, args.n_images, canvas)
            print(f"synthetic fixture: {args.fixture_dir}")

    from cpt_tpu_torch.tools.extract_features import main as extract

    common = ["--task", "refcoco",
              "--ann_file", os.path.join(args.fixture_dir, "ann.json"),
              "--det_file", os.path.join(args.fixture_dir, "det.json"),
              "--image_root", os.path.join(args.fixture_dir, "images"),
              "--dtype", args.dtype, "--device", args.device]
    if args.vinvl:
        common += ["--checkpoint", args.vinvl]
    if args.dryrun:
        common += ["--tiny"]

    exact_tsv = os.path.join(args.workdir, "predictions.tsv")
    extract(common + ["--output", exact_tsv, "--overwrite"])

    report = {"exact_tsv": exact_tsv, "vinvl": args.vinvl,
              "oscar": args.oscar}

    if args.windowed_drift:
        wnd_tsv = os.path.join(args.workdir, "predictions_windowed.tsv")
        extract(common + ["--output", wnd_tsv, "--overwrite",
                          "--windowed", "--allow-approximate"])
        report["windowed_tsv"] = wnd_tsv
        report["windowed_drift"] = tsv_feature_drift(exact_tsv, wnd_tsv)

    # stage 2: zero-shot CPT scoring on the exact features
    det2 = os.path.join(args.workdir, "stage2_det.json")
    det_json_for_stage2(exact_tsv, det2)
    from cpt_tpu_torch.tools.refcoco_cpt import main as stage2

    s2_args = ["--data_file", exact_tsv,
               "--ann_file", os.path.join(args.fixture_dir, "ann.json"),
               "--det_file", det2, "--dtype", args.dtype,
               "--device", args.device]
    if args.dryrun:
        dim = tsv_feature_dim(exact_tsv)
        args.oscar, bcfg = make_dryrun_oscar(args.workdir, dim)
        s2_args += ["--hidden_size", str(bcfg.hidden_size),
                    "--num_hidden_layers", str(bcfg.num_hidden_layers),
                    "--img_feature_dim", str(dim),
                    "--per_gpu_eval_batch_size", "16"]
    if args.oscar:
        s2_args += ["--checkpoint", args.oscar]
    if args.vocab:
        s2_args += ["--vocab", args.vocab]
    acc = stage2(s2_args)
    report["oscar"] = args.oscar
    report["zero_shot_accuracy"] = float(acc)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
