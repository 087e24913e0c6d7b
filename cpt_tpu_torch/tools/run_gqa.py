"""GQA full-finetune runner, ``ImageBertForSequenceClassification`` with xe
(port of ``cpt_tpu/tools/run_gqa.py``).

As the reference ``Oscar/oscar/run_gqa.py`` (the basis of the forked
``fewshot/gqa_ft.py``) does it: the VQA pipeline with hard-label cross
entropy over the GQA answer vocabulary and the test-std submission rows
``{"questionId": str, "prediction": str}`` (``run_gqa.py:696-703``) in
``submission_results.json``. ``run_vqa`` with GQA's defaults; every other
flag is ``run_vqa``'s.

  python -m cpt_tpu_torch.tools.run_gqa --feat_file predictions.tsv \\
      --examples train.json --num_labels 1853 [--test_examples test.json]
"""
from __future__ import annotations

import sys

from cpt_tpu_torch.tools.run_vqa import main as vqa_main


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--loss_type" not in argv:
        argv += ["--loss_type", "xe"]
    if "--submission_format" not in argv:
        argv += ["--submission_format", "gqa"]
    if "--test_name" not in argv:
        argv += ["--test_name", "submission"]
    return vqa_main(argv)


if __name__ == "__main__":
    main()
