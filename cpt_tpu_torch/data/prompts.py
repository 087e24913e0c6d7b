"""Colorful-prompt text for RefCOCO grounding and VCR (the port's copy of
the RefCOCO and VCR parts of ``cpt_tpu/data/prompts.py``).

Candidate regions are marked with semi-transparent colors and the task is
reformulated as color-word prediction: the few-shot template
``"<caption> is in [MASK] color."`` with the color word prefixed to the
colored object's od-label (reference
``Oscar/oscar/datasets/refcoco_fsl_cpt_dataset.py:47-66``), and the
zero-shot template variants (``refcoco_zsl_cpt_dataset.py``). VCR names
its entities in text by object name and paint color ("person in red",
reference ``vcr_nsp_cpt.py:153-162``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

NONE_TOKEN = "none"
# the RefCOCO paint color: one red, alpha 127 (refcocodataset.py:216)
REFCOCO_COLORS: List[Tuple[str, Tuple[int, int, int, int]]] = [
    ("red", (240, 0, 30, 127))]
# the 6-slot palette of the GQA and VCR paint (gqadataset.py:107-110,
# vcrdataset.py:121-124); "blue" appears twice, as in the reference
CROSS_TASK_COLORS: List[Tuple[str, Tuple[int, int, int, int]]] = [
    ("blue", (0, 10, 255, 127)),
    ("red", (240, 0, 30, 127)),
    ("yellow", (255, 255, 25, 127)),
    ("blue", (0, 10, 255, 127)),
    ("purple", (155, 50, 210, 127)),
    ("green", (0, 255, 0, 127)),
]


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


def refcoco_zsl_prompt(caption: str, posi_tokens: Sequence[int],
                       template: int = 3) -> str:
    """Zero-shot template variants (1-6). ``posi_tokens`` are character
    positions of the grounded entity within the caption (templates 4-6)."""
    caption = caption.replace(".", "").strip() if template <= 3 else caption
    if template == 1:
        return caption + " is [MASK]."
    if template == 2:
        return caption + " is [MASK] color."
    if template == 3:
        return caption + " is in [MASK] color."
    if template == 4:
        p = posi_tokens[-1]
        return (caption[:p] + " in [MASK]." if p == len(caption)
                else caption[:p] + " in [MASK]" + caption[p:] + ".")
    if template == 5:
        p = posi_tokens[-1]
        return (caption[:p] + " in [MASK] color." if p == len(caption)
                else caption[:p] + " in [MASK] color" + caption[p:] + ".")
    if template == 6:
        p = posi_tokens[0]
        return caption[:p] + "[MASK] " + caption[p:] + "."
    raise ValueError(f"unknown template {template}")


def vcr_entity_key(ids: Sequence[int]) -> str:
    """Canonical key for an entity id list: sorted, underscore-joined."""
    return "_".join(str(i) for i in sorted(ids))


def vcr_textize(sentence: Sequence, colors: Dict[str, str],
                names: Dict[str, str], colorful: bool = True) -> str:
    """Replace entity-id lists in a VCR tokenized sentence with object names,
    optionally suffixed with their marked color ("person in red")."""
    words: List[str] = []
    for w in sentence:
        if isinstance(w, list):
            key = vcr_entity_key(w)
            if colorful and key in colors:
                words.append(f"{names[key]} in {colors[key]}")
            else:
                words.append(names[key])
        else:
            words.append(str(w))
    return " ".join(words)
