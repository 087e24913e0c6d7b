"""Colorful-prompt text for RefCOCO grounding, VG relations, GQA and VCR
(the port's copy of ``cpt_tpu/data/prompts.py``).

Candidate regions are marked with semi-transparent colors and the task is
reformulated as color-word prediction: the few-shot template
``"<caption> is in [MASK] color."`` with the color word prefixed to the
colored object's od-label (reference
``Oscar/oscar/datasets/refcoco_fsl_cpt_dataset.py:47-66``), and the
zero-shot template variants (``refcoco_zsl_cpt_dataset.py``). VG asks for
the relation of a red subject and a blue object through k = 1..3 [MASK]s
with per-width "no relation" fillers (``vg_cpt_dataset.py:44-75``); GQA
inserts color words into the question at the parsed entity positions
(``gqa_cpt.py:238-250``). VCR names its entities in text by object name
and paint color ("person in red", reference ``vcr_nsp_cpt.py:153-162``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

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
# VG's pair paint: subject red, object blue (vgdataset.py:93)
VG_PAIR_COLORS: List[Tuple[int, int, int, int]] = [(240, 0, 30, 127),
                                                   (0, 10, 255, 127)]
VG_PAIR_COLOR_NAMES: Tuple[str, str] = ("red", "blue")


def refcoco_fsl_prompt(caption: str) -> str:
    return caption.replace(".", "").strip() + " is in [MASK] color."


def refcoco_soft_prompt(caption: str, n_pre: int = 2,
                        n_post: int = 2) -> str:
    """Continuous-template prompt: the FSL template's words replaced by
    learnable ``[unusedN]`` slots around [MASK] (the reference's
    sgd_to_explore_template.py TemplateEmbedding substitutes trainable
    vectors at token ids 1-20; slot ids here are those same [unusedN]
    vocab rows). The tokenizer must register the slots via
    ``add_special_tokens`` so they stay whole."""
    pre = " ".join(f"[unused{i}]" for i in range(1, n_pre + 1))
    post = " ".join(f"[unused{i}]"
                    for i in range(n_pre + 1, n_pre + n_post + 1))
    return f"{caption.replace('.', '').strip()} {pre} [MASK] {post}".strip()


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


REL_CANONICALIZE = {"has": "having", "wears": "wearing", "says": "saying"}
VG_NA_FILLERS: Dict[int, str] = {0: "irrelevant", 1: "no relation",
                                 2: " no relation with"}
VG_MAX_MASK_WIDTH = 3


def vg_subject_object_names(subj: str, obj: str,
                            colors: Tuple[str, str] = VG_PAIR_COLOR_NAMES
                            ) -> Tuple[str, str]:
    return (f"{subj} in {colors[0]} color", f"{obj} in {colors[1]} color")


def vg_prompt(subj: str, obj: str, mask_width: int,
              colors: Tuple[str, str] = VG_PAIR_COLOR_NAMES) -> str:
    s, o = vg_subject_object_names(subj, obj, colors)
    return f"{s} is" + " [MASK]" * mask_width + f" a {o}"


def vg_od_labels_with_colors(od_labels: Sequence[str], pair: Tuple[int, int],
                             colors: Tuple[str, str] = VG_PAIR_COLOR_NAMES
                             ) -> str:
    def name(i: int, lbl: str) -> str:
        if i == pair[0]:
            return f"{colors[0]} {lbl}"
        if i == pair[1]:
            return f"{colors[1]} {lbl}"
        return lbl

    return " ".join(name(i, lbl) for i, lbl in enumerate(od_labels))


def vg_filler_label_ids(rel_token_ids: Sequence[int],
                        tokenize_fn: Callable[[str], Sequence[int]]
                        ) -> List[List[int]]:
    """Per-width label token lists: the true relation at its own width, the
    "no relation" filler at the others (reference ``vg_cpt_dataset.py:71-74``)."""
    labels = [list(tokenize_fn(VG_NA_FILLERS[i]))
              for i in range(VG_MAX_MASK_WIDTH)]
    labels[len(rel_token_ids) - 1] = list(rel_token_ids)
    return labels


def gqa_rewrite_question(question: str,
                         positions_and_colors: Sequence[Tuple[Sequence[int], str]]
                         ) -> str:
    """Insert color words into the question at parsed entity end-positions.

    ``positions_and_colors``: [((start, ...), color_name), ...], the stage-1
    meta written next to the colored features; insertion is by character
    position as the reference does it (``gqa_cpt.py:238-250``)."""
    positions = [0] + [pc[0][0] for pc in positions_and_colors]
    colors = [pc[1] for pc in positions_and_colors]
    out: List[str] = []
    for i in range(len(positions) - 1):
        out.append(question[positions[i]:positions[i + 1]])
        out.append(colors[i] + " ")
    out.append(question[positions[-1]:])
    return "".join(out)


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
