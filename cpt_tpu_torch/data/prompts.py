"""Colorful-prompt text for RefCOCO grounding (the port's copy of the
RefCOCO part of ``cpt_tpu/data/prompts.py``).

Candidate regions are marked with semi-transparent colors and the task is
reformulated as color-word prediction: the few-shot template
``"<caption> is in [MASK] color."`` with the color word prefixed to the
colored object's od-label (reference
``Oscar/oscar/datasets/refcoco_fsl_cpt_dataset.py:47-66``).
"""
from __future__ import annotations

from typing import Sequence


def refcoco_fsl_prompt(caption: str) -> str:
    return caption.replace(".", "").strip() + " is in [MASK] color."


def refcoco_od_labels_with_color(od_labels: Sequence[str], colored_idx: int,
                                 color_name: str) -> str:
    """Prefix the color word to the colored object's label in the od-label
    string fed as text_b."""
    return " ".join(
        f"{color_name} {lbl}" if i == colored_idx else lbl
        for i, lbl in enumerate(od_labels)
    )
