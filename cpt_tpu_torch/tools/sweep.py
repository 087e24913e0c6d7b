"""CPT few-shot sweep driver — the N_SHOT × seeds acceptance protocol
(port of ``cpt_tpu/tools/sweep.py``).

One command replacing the reference's shell loops
(``Oscar/cmds/refcoco/fsl/run.sh``: for seed in 0..4 { stage-1 extraction
with N_SHOT/RAND_SEED → stage-2 prompt-tune → eval splits };
``Oscar/cmds/gqa/cpt_fsl.sh``: for N_SHOT in 4 16 64 128 × 5 seeds).
Each run's result lands as ``<task>_shot{N}_seed{S}.pk`` — the exact input
format of ``tools/fewshot_eval.py`` — and the final mean±std table prints
at the end.

Stage templates are argument lists for the underlying drivers with
``{shot}``/``{seed}``/``{batch}``/``{train_tsv}`` placeholders, mirroring
how ``run.sh`` threads $N_SHOT/$i/$BATCH through its scripts:

  python -m cpt_tpu_torch.tools.sweep --task refcoco \
      --shots 1 2 4 8 --seeds 0 1 2 3 4 --results_dir out/ \
      --extract -- --ann_file a.json --det_file d.json \
          --output out/train_shot{shot}_seed{seed}.tsv \
          --n_shot {shot} --rand_seed {seed} \
      --stage2 -- --data_file val.tsv --ann_file a.json --det_file d.json \
          --train_data_file {train_tsv} --per_gpu_train_batch_size {batch}

``--extract`` is optional (GQA samples its shots in-driver via
--n_sample/--random_seed, so only ``--stage2`` is needed there). Stage-1
outputs are cached: extract_features skips existing TSVs unless
--overwrite is in the template. The stage-2 drivers are this package's
``refcoco_cpt`` / ``gqa_cpt`` / ``vcr_nsp_cpt`` / ``vg_cpt`` and stage 1 its
``extract_features``; each runs on the card unless its template passes
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import pickle

from cpt_tpu_torch.engine.evaluate import seed_sweep_report
from cpt_tpu_torch.parallel import distributed

TASKS = ("refcoco", "gqa", "vcr", "vg")


def _split_templates(argv):
    """Pull off ``--extract -- ...`` / ``--stage2 -- ...`` tail sections."""
    own, extract, stage2 = [], None, None
    cur = own
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--extract":
            extract = []
            cur = extract
            i += 2 if i + 1 < len(argv) and argv[i + 1] == "--" else 1
            continue
        if a == "--stage2":
            stage2 = []
            cur = stage2
            i += 2 if i + 1 < len(argv) and argv[i + 1] == "--" else 1
            continue
        cur.append(a)
        i += 1
    return own, extract, stage2


def build_args():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="refcoco", choices=TASKS)
    p.add_argument("--shots", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--results_dir", required=True)
    p.add_argument("--metric", default="accuracy")
    p.add_argument("--max_batch", type=int, default=16,
                   help="few-shot batch cap (run.sh: BATCH=min(N_SHOT,16))")
    p.add_argument("--resume", action="store_true",
                   help="skip (shot, seed) runs whose result .pk exists")
    return p


def _fill(template, mapping):
    return [t.format(**mapping) for t in template]


def stage2_main(task):
    if task == "refcoco":
        from cpt_tpu_torch.tools.refcoco_cpt import main
    elif task == "gqa":
        from cpt_tpu_torch.tools.gqa_cpt import main
    elif task == "vcr":
        from cpt_tpu_torch.tools.vcr_nsp_cpt import main
    else:
        from cpt_tpu_torch.tools.vg_cpt import main
    return main


def run_sweep(args, extract_tpl, stage2_tpl):
    os.makedirs(args.results_dir, exist_ok=True)
    results = {}
    main2 = stage2_main(args.task)
    for shot in args.shots:
        for seed in args.seeds:
            out_pk = os.path.join(
                args.results_dir, f"{args.task}_shot{shot}_seed{seed}.pk")
            if args.resume and os.path.exists(out_pk):
                blob = pickle.load(open(out_pk, "rb"))
                results.setdefault(shot, {})[seed] = blob[args.metric]
                print(f"[sweep] shot={shot} seed={seed}: cached "
                      f"{blob[args.metric]:.2f}")
                continue
            mapping = {"shot": shot, "seed": seed,
                       "batch": min(shot, args.max_batch) or 1}
            train_tsv = None
            if extract_tpl is not None:
                from cpt_tpu_torch.tools.extract_features import main as extract

                eargs = _fill(extract_tpl, mapping)
                extract(eargs)
                if "--output" in eargs:
                    train_tsv = eargs[eargs.index("--output") + 1]
            mapping["train_tsv"] = train_tsv or ""
            acc = main2(_fill(stage2_tpl, mapping))
            results.setdefault(shot, {})[seed] = float(acc)
            pickle.dump({args.metric: float(acc), "shot": shot,
                         "seed": seed}, open(out_pk, "wb"))
            print(f"[sweep] shot={shot} seed={seed}: "
                  f"{args.metric}={float(acc):.2f}")
    return results


def main(argv=None):
    import sys

    distributed.initialize_from_env()
    argv = list(sys.argv[1:] if argv is None else argv)
    own, extract_tpl, stage2_tpl = _split_templates(argv)
    args = build_args().parse_args(own)
    if stage2_tpl is None:
        raise SystemExit("--stage2 -- <driver args...> is required")
    results = run_sweep(args, extract_tpl, stage2_tpl)
    print(seed_sweep_report(results))
    return results


if __name__ == "__main__":
    main()
