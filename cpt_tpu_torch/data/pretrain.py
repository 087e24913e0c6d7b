"""Oscar+ pretraining dataset: MLM + contrastive (text-b swap).

Parity with reference ``Oscar/oscar/datasets/oscar_tsv.py`` (``OscarTSVData-
set:256-``, driver ``run_oscarplus_pretrain.py``): each item is
``[CLS] caption [SEP] od_labels [SEP]`` + region features; with probability
0.5 the od-label side is swapped with a random other image's tags and the
contrastive label flips to 1 ("polluted"); caption tokens are masked
BERT-style (15%, 80/10/10) for the MLM objective. Loss = MLM CE + NSP-style
contrastive CE (``BertImgForPreTraining``).

The port's copy of ``cpt_tpu/data/pretrain.py`` (its code unchanged, its
imports pointed at the port's modules).
"""
from __future__ import annotations

import json
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cpt_tpu_torch.data.tensorize import pad_img_feats, tensorize_pair
from cpt_tpu_torch.utils.tokenization import BertTokenizer
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


def mask_tokens(input_ids: np.ndarray, maskable: np.ndarray,
                tokenizer: BertTokenizer, rng: random.Random,
                mask_prob: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """BERT masking: → (masked input_ids, mlm_labels [-1 = unmasked])."""
    ids = input_ids.copy()
    labels = np.full_like(ids, -1)
    vocab_items = list(tokenizer.vocab.values())
    for i in range(len(ids)):
        if not maskable[i]:
            continue
        if rng.random() < mask_prob:
            labels[i] = ids[i]
            r = rng.random()
            if r < 0.8:
                ids[i] = tokenizer.mask_token_id
            elif r < 0.9:
                ids[i] = rng.choice(vocab_items)
    return ids, labels


def pretrain_contrast_classes(texta_false_prob: float, use_b: bool) -> int:
    """Reference rule (run_oscarplus_pretrain.py:245 comment /
    oscar_tsv.py:275): 3-way contrastive when wrong-text_a corruption is
    in play (and distinguishable), else the plain 2-way."""
    return 3 if (texta_false_prob < 0.5
                 and (texta_false_prob > 0 or not use_b)) else 2


class OscarPretrainData:
    def __init__(self, feat_file: str, captions: dict,
                 tokenizer: BertTokenizer, max_seq_len: int = 35,
                 img_seq_len: int = 50, img_feat_dim: int = 2054,
                 text_b_swap_prob: float = 0.5,
                 texta_false_prob: float = 0.0, use_b: bool = True,
                 mask_loss_for_unmatched: bool = True,
                 textb_sample_mode: int = 0):
        """captions: {img_key: caption string}.

        Corruption scheme (reference ``oscar_tsv.py:263-283``, one dice
        draw): ``dice > 0.5`` → clean (label 0);
        ``texta_false_prob < dice ≤ 0.5`` → od labels swapped with
        another image's tags (label 1, "polluted tags");
        ``dice ≤ texta_false_prob`` → the CAPTION is swapped
        (wrong-text_a retrieval triplet, label ``num_contrast_classes −
        1``) — so ``texta_false_prob`` is the ABSOLUTE wrong-caption
        probability, not conditional on corrupting. ``use_b=False``
        drops the od-label segment entirely (caption ⊕ regions only);
        text_a corruption then carries the contrast signal.

        ``textb_sample_mode`` picks the SOURCE of the polluting text_b
        (reference ``run_oscarplus_pretrain.py:78-82`` +
        ``oscar_tsv.py:315-345``; a doc is [id, text_a, text_b]):
        0 = a random LINE of a random other doc — caption or tags, 50/50
        (``rand_doc[randrange(1, 3)]``, the reference main-corpus
        default); 1 = the other doc's text_b (tags) line; 2 = like 1 but
        drawn from the qa-doc pool — with our one-corpus-per-dataset
        layout (qa corpora arrive via ``--extra_yaml``) the pool IS the
        dataset, so 2 behaves as 1 here.
        """
        self.tsv = TSVFile(feat_file)
        self.imgid2idx = {self.tsv.seek(i)[0]: i for i in range(len(self.tsv))}
        self.keys = sorted(k for k in captions if k in self.imgid2idx)
        self.captions = captions
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim
        self.swap_prob = text_b_swap_prob
        self.texta_false_prob = texta_false_prob
        self.use_b = use_b
        self.mask_loss_for_unmatched = mask_loss_for_unmatched
        self.textb_sample_mode = textb_sample_mode
        self.num_contrast_classes = pretrain_contrast_classes(
            texta_false_prob, use_b)

    def __len__(self):
        return len(self.keys)

    def _feats(self, img_key: str):
        _, payload = self.tsv.seek(self.imgid2idx[img_key])
        info = json.loads(payload)
        boxlist = info["objects"]
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        od = " ".join(o["class"] for o in boxlist)
        return feats, od

    def batch(self, indices: Sequence[int], rng: random.Random,
              pad_to: Optional[int] = None):
        """→ (ids, segs, attn, feats, mlm_labels, contrastive_labels)."""
        n = len(indices)
        total = pad_to if pad_to is not None else n
        t, r, d = self.max_seq_len, self.img_seq_len, self.img_feat_dim
        ids = np.zeros((total, t), np.int32)
        segs = np.zeros((total, t), np.int32)
        attn = np.zeros((total, t + r), np.int32)
        feats = np.zeros((total, r, d), np.float32)
        mlm = np.full((total, t + r), -1, np.int32)
        contrast = np.full((total,), -1, np.int32)
        for i, idx in enumerate(indices):
            key = self.keys[idx]
            f, od = self._feats(key)
            caption = self.captions[key]
            # oscar_tsv.py:264-283 corruption ladder, one dice draw:
            # dice > 0.5 → clean; texta_false_prob < dice ≤ 0.5 → wrong
            # text_b (label 1); dice ≤ texta_false_prob → wrong text_a
            # (label K−1). texta_false_prob is the ABSOLUTE probability of
            # the wrong-caption branch, exactly as the reference rolls it
            # (swap_prob keeps the historical knob: P(corrupt) = swap_prob
            # instead of 0.5).
            label = 0
            polluted_tags = False
            dice = rng.random()
            if dice < self.swap_prob and len(self.keys) > 1:
                other = rng.choice([k for k in self.keys if k != key])
                if dice >= self.texta_false_prob and self.use_b:
                    # textb_sample_mode 0: random line of the other doc
                    # (caption or tags, oscar_tsv.py:339-344); 1/2: its
                    # text_b (tags) line
                    if self.textb_sample_mode == 0 and rng.random() < 0.5:
                        od = self.captions[other]
                    else:
                        _, od = self._feats(other)
                    label = 1
                    polluted_tags = True
                else:
                    caption = self.captions[other]
                    label = self.num_contrast_classes - 1
            seq = tensorize_pair(self.tokenizer, caption,
                                 od if self.use_b else None,
                                 f.shape[0], t, r)
            toks = seq.input_ids.tolist()
            sep_id = self.tokenizer.sep_token_id
            sep = toks.index(sep_id)
            maskable = np.zeros((t,), bool)
            maskable[1:sep] = True                   # caption tokens
            if self.use_b:                           # od-label tokens too
                try:                                 # (oscar_tsv random_word
                    sep2 = toks.index(sep_id, sep + 1)   # masks both sides)
                    # mask_loss_for_unmatched=0 + polluted tags: the
                    # reference SKIPS random_word on tokens_b entirely
                    # (oscar_tsv.py:693-696) — tags stay intact in the
                    # input AND carry no labels. Note the 2-way
                    # texta_false_prob=0.5 config relabels its caption
                    # swaps is_next_type=2 (oscar_tsv.py:686-687), so
                    # only true tag pollution skips — tracked here via
                    # polluted_tags, not the label value.
                    if self.mask_loss_for_unmatched or not polluted_tags:
                        maskable[sep + 1:sep2] = True
                except ValueError:
                    pass
            masked, labels = mask_tokens(seq.input_ids, maskable,
                                         self.tokenizer, rng)
            ids[i] = masked
            segs[i] = seq.segment_ids
            attn[i] = seq.attention_mask
            feats[i] = pad_img_feats(f, r)
            mlm[i, :t] = labels
            contrast[i] = label
        return ids, segs, attn, feats, mlm, contrast


class MultiCorpusPretrainData(OscarPretrainData):
    """Multi-corpus Oscar+ pretraining mixing (reference ``oscar_tsv.py:
    16-200``): one corpus TSV interleaving several datasets, per-dataset
    region-feature TSVs, optional per-chunk splits with chunk-range
    filtering (GoogleCC/SBU/OI-style sharded corpora).

    yaml descriptor (paths relative to the yaml)::

        corpus: coco_flickr30k_googlecc     # '_'-joined dataset names
        corpus_file: corpus.tsv             # rows [<ds>_<imgid>, caption]
        image_feature_path:
          coco: coco_features.tsv           # one TSV per dataset...
          googlecc:                         # ...or {chunk_id: TSV} splits
            "0": cc_chunk0.tsv
            "1": cc_chunk1.tsv

    Rows whose dataset is not in ``corpus`` are skipped, as are rows of
    chunked datasets outside [chunk_start_id, chunk_end_id) — the
    reference's ``--chunk_start_id/--chunk_end_id`` pod-sharding knobs
    (``oscar_tsv.py:68-72,110-113``). Text-b ("polluted tags") swaps
    sample across the whole mixed corpus, like the reference's random-doc
    draw.
    """

    def __init__(self, yaml_file: str, tokenizer: BertTokenizer,
                 max_seq_len: int = 35, img_seq_len: int = 50,
                 img_feat_dim: int = 2054, text_b_swap_prob: float = 0.5,
                 chunk_start_id: int = -1, chunk_end_id: int = -1,
                 texta_false_prob: float = 0.0, use_b: bool = True,
                 mask_loss_for_unmatched: bool = True,
                 textb_sample_mode: int = 0):
        import os

        import yaml as _yaml

        root = os.path.dirname(os.path.abspath(yaml_file))
        cfg = _yaml.safe_load(open(yaml_file))
        names = cfg["corpus"].split("_")
        chunk_list = None
        if 0 <= chunk_start_id <= chunk_end_id:
            chunk_list = {str(c) for c in range(chunk_start_id,
                                                chunk_end_id)}

        self._tsvs = {}            # (dataset, chunk|None) -> TSVFile
        self._index = {}           # "<ds>_<imgid>" -> (tsv, row)
        for ds, spec in cfg["image_feature_path"].items():
            if ds not in names:
                continue
            specs = (spec.items() if isinstance(spec, dict)
                     else [(None, spec)])
            for chunk, path in specs:
                if (chunk is not None and chunk_list is not None
                        and str(chunk) not in chunk_list):
                    continue
                tsv = TSVFile(os.path.join(root, path))
                self._tsvs[(ds, chunk)] = tsv
                for i in range(len(tsv)):
                    self._index[f"{ds}_{tsv.seek(i)[0]}"] = (tsv, i)

        corpus = TSVFile(os.path.join(root, cfg["corpus_file"]))
        captions, keys = {}, []
        for i in range(len(corpus)):
            row = corpus.seek(i)
            key = row[0]
            ds = key.split("_")[0]
            if ds == "cc":
                ds = "googlecc"
                key = "googlecc_" + key.split("_", 1)[1]
            if ds not in names or key not in self._index:
                continue
            keys.append(key)
            captions[key] = row[-1]

        self.keys = keys
        self.captions = captions
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim
        self.swap_prob = text_b_swap_prob
        self.texta_false_prob = texta_false_prob
        self.use_b = use_b
        self.mask_loss_for_unmatched = mask_loss_for_unmatched
        self.textb_sample_mode = textb_sample_mode
        self.num_contrast_classes = pretrain_contrast_classes(
            texta_false_prob, use_b)
        self.datasets = names

    def _feats(self, img_key: str):
        tsv, row = self._index[img_key]
        _, payload = tsv.seek(row)
        info = json.loads(payload)
        boxlist = info["objects"]
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        od = " ".join(o["class"] for o in boxlist)
        return feats, od
