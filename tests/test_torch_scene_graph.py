"""The scene-graph path, port vs JAX package, on the CPU in f32 at
``tiny_detector_config`` (``max_rel_dets`` 4): one flax LSTM and GRU step
against the port's cells on the carried weights, each relation head's
logits (RelDN with and without the frequency prior, IMP, MSDN, GRCNN,
Neural Motif; the motif's label-0 defect shown), the pair functions and
losses, ``SceneParser`` inference over a 2-image VG-TSV fixture for all five
algorithms with ``sg_infer``'s recall, ``test_detector --sg`` and
``train_detector --sg`` against the JAX ``main``s.

The JAX trees come across through ``models/detector/convert.
params_from_jax``. The relation heads' random initializations cannot be
shared, so the tool comparisons hand both packages one flax-drawn relation
tree: the JAX ``SceneParser.init`` (and, in ``test_detector``,
``AttrRCNN.init``, whose values ``--checkpoint`` replaces) is patched to
return it, and the port's ``SceneParser.init_relation`` to load it."""
import dataclasses
import functools
import os
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.data import vg_tsv as jvg
from cpt_tpu.engine import sg_eval as jsg_eval
from cpt_tpu.engine import sg_infer as jsg_infer
from cpt_tpu.models.detector import motif as jmotif
from cpt_tpu.models.detector import relation_head as jrh
from cpt_tpu.models.detector import relation_variants as jrv
from cpt_tpu.models.detector import scene_parser as jsp
from cpt_tpu.models.detector.config import tiny_detector_config as jtiny
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.models.detector.resnet import ResNetC5Head as JC5Head
from cpt_tpu.models.detector.rpn import grid_anchors as jgrid_anchors
from cpt_tpu.tools import test_detector as jtest_tool
from cpt_tpu.tools import train_detector as jtrain_tool
from cpt_tpu_torch.data import vg_tsv
from cpt_tpu_torch.engine import sg_infer
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector import motif
from cpt_tpu_torch.models.detector import relation_head as rh
from cpt_tpu_torch.models.detector import relation_variants as rv
from cpt_tpu_torch.models.detector.config import tiny_detector_config
from cpt_tpu_torch.models.detector.heads import c5_channels
from cpt_tpu_torch.models.detector.rpn import grid_anchors
from cpt_tpu_torch.models.detector.scene_parser import (ALGORITHMS, SceneParser,
                                                        triplet_predictions)
from cpt_tpu_torch.tools import test_detector as test_tool
from cpt_tpu_torch.tools import train_detector as train_tool
from cpt_tpu_torch.utils import checkpoint as ckpt_lib
from test_torch_watchdog import guards

guard_module, guard_case = guards(400)

HEAD_TOL = 1e-5       # a head's logits against flax, as a fraction of scale
FN_TOL = 1e-6         # pair features, labels, losses
SP_TOL = 1e-4         # SceneParser boxes and logits (the detector under it)
LOSS_TOL = 1e-4       # train_detector --sg against the JAX tool
PARAM_TOL = 1e-4      # trained relation leaves, as a fraction of scale
R = 4                 # the fixture's predicates + no-relation
K = 4                 # max_rel_dets
JCFG, CFG = jtiny(), tiny_detector_config()
C4 = CFG.backbone.out_channels
D = c5_channels(CFG)
NCLS = CFG.roi_heads.num_classes
LABELMAP = {"label_to_idx": {"cat": 1, "dog": 2, "car": 3, "tree": 4},
            "attribute_to_idx": {"red": 1},
            "predicate_to_idx": {"on": 1, "near": 2, "to the left of": 3}}


def gap(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- the inputs of the head-level cases ----------------------------------------

@functools.lru_cache(maxsize=None)
def head_inputs() -> dict:
    rng = np.random.RandomState(20)
    xy = rng.uniform(0, 40, (K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(6, 24, (K, 2))], 1)
    valid = np.array([True, True, True, False])
    pairs = np.array([(i, j) for i in range(K) for j in range(K) if i != j])
    logits = rng.randn(K, NCLS)
    dists = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {
        "feat_map": rng.randn(8, 8, C4).astype(np.float32),
        "boxes": boxes.astype(np.float32), "labels": np.array([1, 2, 3, 1]),
        "box_feats": rng.randn(K, D).astype(np.float32),
        "union": rng.randn(len(pairs), D).astype(np.float32),
        "dists": dists.astype(np.float32), "valid": valid, "pairs": pairs,
        "pair_valid": valid[pairs[:, 0]] & valid[pairs[:, 1]],
        "freq": rng.rand(NCLS, NCLS, R).astype(np.float32),
        "hw": np.array([64, 60])}


def jax_head(name):
    """The flax module of ``name`` and its call's positional arguments."""
    x = {k: jnp.asarray(v) for k, v in head_inputs().items()}
    if name == "sg_reldn":
        return jrh.RelDNHead(JCFG, R), (x["feat_map"], x["boxes"], x["labels"],
                                        x["box_feats"], x["pairs"],
                                        x["pair_valid"], x["hw"], x["freq"])
    if name == "sg_nm":
        return (jmotif.NeuralMotifHead(NCLS, R, obj_dim=D),
                (x["box_feats"], x["dists"], x["boxes"],
                 x["hw"].astype(jnp.float32), x["valid"], x["union"],
                 x["pairs"], x["pair_valid"]))
    cls = {"sg_imp": jrv.IMPHead, "sg_msdn": jrv.MSDNHead,
           "sg_grcnn": jrv.GRCNNHead}[name]
    return cls(NCLS, R), (x["box_feats"], x["union"], x["pairs"], x["valid"],
                          x["pair_valid"])


@functools.lru_cache(maxsize=None)
def jax_head_run(name):
    """(numpy params of the head ``name``, its outputs as numpy)."""
    module, args = jax_head(name)
    params = jax.jit(module.init)(jax.random.PRNGKey(ALGORITHMS.index(name)),
                                  *args)
    out = jax.jit(module.apply)(params, *args)
    return np_tree(params), np_tree(out)


def port_head(name, params):
    if name == "sg_reldn":
        head = rh.RelDNHead(CFG, R)
    elif name == "sg_nm":
        head = motif.NeuralMotifHead(NCLS, R, obj_dim=D)
    else:
        head = {"sg_imp": rv.IMPHead, "sg_msdn": rv.MSDNHead,
                "sg_grcnn": rv.GRCNNHead}[name](NCLS, R, obj_dim=D, pred_dim=D)
    head.load_state_dict(dconv.params_from_jax(params, CFG))
    return head.eval()


def port_head_call(name, head):
    x = {k: torch.from_numpy(np.asarray(v)) for k, v in head_inputs().items()}
    with torch.no_grad():
        if name == "sg_reldn":
            return head(x["feat_map"], x["boxes"], x["labels"], x["box_feats"],
                        x["pairs"], x["pair_valid"], tuple(x["hw"].tolist()),
                        x["freq"])
        if name == "sg_nm":
            return head(x["box_feats"], x["dists"], x["boxes"],
                        tuple(x["hw"].tolist()), x["valid"], x["union"],
                        x["pairs"], x["pair_valid"])
        return head(x["box_feats"], x["union"], x["pairs"], x["valid"],
                    x["pair_valid"])


# --- recurrent cells -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_cell_step_matches_flax(kind):
    """One step of flax ``nn.LSTMCell`` / ``nn.GRUCell`` against the port's
    ``torch.nn`` cell on the carried weights (LSTM: input Denses without
    bias, [i, f, g, o], carry (c, h); GRU: ``bias_hh`` = [0, 0, b_hn]). A
    permuted gate order also gives finite numbers, so the comparison is
    against flax, and the i/f-swapped LSTM must miss."""
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(3, 5).astype(np.float32))
    h0 = rng.randn(3, 6).astype(np.float32)
    c0 = rng.randn(3, 6).astype(np.float32)
    cell = fnn.LSTMCell(6) if kind == "lstm" else fnn.GRUCell(6)
    carry = (jnp.asarray(c0), jnp.asarray(h0)) if kind == "lstm" else jnp.asarray(h0)
    params = np_tree(cell.init(jax.random.PRNGKey(4), carry, x))
    # biases drawn too (flax starts them at 0), so a misplaced one shows
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.randn(*v.shape).astype(np.float32)
        if p[-1].key == "bias" else v, params)
    new_carry, _ = cell.apply(params, carry, x)
    sd = {k.split(".", 1)[1]: v for k, v in
          dconv.params_from_jax({"cell": params["params"]}, CFG).items()}
    tx, th, tc = (torch.from_numpy(np.array(a)) for a in (x, h0, c0))
    if kind == "lstm":
        tcell = motif.lstm_cell(5, 6)
        tcell.load_state_dict(sd)
        got_h, got_c = motif.lstm_step(tcell, tx, (th, tc), torch.float32)
        assert gap(got_h, new_carry[1]) <= HEAD_TOL
        assert gap(got_c, new_carry[0]) <= HEAD_TOL
        w = tcell.weight_ih.data.clone()
        tcell.weight_ih.data[:6], tcell.weight_ih.data[6:12] = w[6:12], w[:6]
        wrong_h, _ = motif.lstm_step(tcell, tx, (th, tc), torch.float32)
        assert gap(wrong_h, new_carry[1]) > 100 * HEAD_TOL
    else:
        tcell = torch.nn.GRUCell(5, 6)
        tcell.load_state_dict(sd)
        got = rv.gru_step(tcell, th, tx, torch.float32)
        assert gap(got, new_carry) <= HEAD_TOL
        assert not tcell.bias_hh[:12].any()


# --- the heads -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ALGORITHMS)
def test_relation_head_matches_flax(name):
    """Each head's outputs from the flax tree carried across: RelDN's
    logits with the frequency prior (and without it), the others' object
    and predicate logits (and the motif's greedy labels), within HEAD_TOL
    of scale."""
    params, want = jax_head_run(name)
    head = port_head(name, params)
    got = port_head_call(name, head)
    if name == "sg_reldn":
        assert gap(got, want) <= HEAD_TOL
        module, args = jax_head(name)
        no_freq = np.asarray(module.apply(params, *args[:-1], None))
        x = {k: torch.from_numpy(np.asarray(v)) for k, v in head_inputs().items()}
        with torch.no_grad():
            got_nf = head(x["feat_map"], x["boxes"], x["labels"], x["box_feats"],
                          x["pairs"], x["pair_valid"], (64, 60))
        assert gap(got_nf, no_freq) <= HEAD_TOL
        assert gap(got_nf, want) > 1e-2                 # the prior does move it
        assert not got[~torch.from_numpy(head_inputs()["pair_valid"])].any()
        return
    for g, w in zip(got[:2], want[:2]):
        assert gap(g, w) <= HEAD_TOL
    if name == "sg_nm":
        np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_motif_edges_embed_label_zero():
    """The mirrored JAX defect: without gt labels the edge context embeds
    label 0 for every object, not the decoder's predictions. Both packages:
    new decoder output weights change the predicted labels and leave the
    relation logits as they were; a new row 0 of ``obj_embed2`` moves them,
    new other rows do not."""
    params, want = jax_head_run("sg_nm")
    module, args = jax_head("sg_nm")
    ctx = params["params"]["context"]
    rng = np.random.RandomState(9)

    def with_ctx(**changes):
        p = jax.tree_util.tree_map(lambda v: v, params)
        p["params"]["context"] = {**ctx, **changes}
        return p

    out_w = dict(ctx["decoder_rnn"])
    out_w["out"] = {"kernel": rng.randn(*ctx["decoder_rnn"]["out"]["kernel"].shape
                                        ).astype(np.float32) * 5,
                    "bias": ctx["decoder_rnn"]["out"]["bias"]}
    row0 = ctx["obj_embed2"].copy()
    row0[0] += 1.0
    rest = ctx["obj_embed2"].copy()
    rest[1:] += 1.0
    cases = {"decoder": with_ctx(decoder_rnn=out_w),
             "row0": with_ctx(obj_embed2=row0), "rest": with_ctx(obj_embed2=rest)}
    for case, p in cases.items():
        j = np_tree(jax.jit(module.apply)(p, *args))
        got = port_head_call("sg_nm", port_head("sg_nm", np_tree(p)))
        assert gap(got[1], j[1]) <= HEAD_TOL
        moved = gap(got[1], want[1])
        if case == "decoder":
            assert (got[2].numpy() != want[2]).any() and moved <= HEAD_TOL
        else:
            assert (moved > 1e-3) == (case == "row0"), (case, moved)


@pytest.mark.parametrize("pos_encoding", [False, True])
def test_relpn_matches_flax(pos_encoding):
    """RelPN: ``Relationshipness`` (with and without its box position
    encoders) within HEAD_TOL of flax, ``relpn_select_pairs`` (top-K
    off-diagonal pairs, ties to the lower index) and ``relpn_loss`` equal to
    JAX's."""
    x = {k: jnp.asarray(v) for k, v in head_inputs().items()}
    module = jrv.Relationshipness(pos_encoding=pos_encoding)
    args = (x["box_feats"], x["boxes"], x["hw"].astype(jnp.float32))
    params = np_tree(jax.jit(module.init)(jax.random.PRNGKey(7), *args))
    want = np.asarray(jax.jit(module.apply)(params, *args))
    port = rv.Relationshipness(D, pos_encoding)
    port.load_state_dict(dconv.params_from_jax(params, CFG))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in head_inputs().items()}
    with torch.no_grad():
        got = port(t["box_feats"], t["boxes"], (64.0, 60.0))
    assert gap(got, want) <= HEAD_TOL
    rel = np.round(want, 2)                      # ties at 1e-2
    jp, js, jv = jrv.relpn_select_pairs(jnp.asarray(rel), x["valid"], 8)
    tp, ts, tv = rv.relpn_select_pairs(torch.from_numpy(rel), t["valid"], 8)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    adj = np.random.RandomState(8).rand(K, K) < 0.3
    jl = jrv.relpn_loss(jnp.asarray(want), jnp.asarray(adj), x["valid"])
    tl = rv.relpn_loss(torch.from_numpy(want), torch.from_numpy(adj), t["valid"])
    assert abs(float(tl) - float(jl)) <= FN_TOL


@pytest.mark.parametrize("order", ["leftright", "confidence", "size", "random"])
def test_sort_rois_is_stable(order):
    """``sort_rois`` in each order equals ``jnp.argsort``'s stable one, on
    boxes whose centres, scores and areas tie, with invalid slots last."""
    boxes = np.array([[0, 0, 10, 10], [2, 5, 8, 9], [0, 0, 10, 10], [4, 1, 6, 9],
                      [1, 1, 9, 9], [0, 0, 10, 10]], np.float32)
    scores = np.array([0.5, 0.7, 0.5, 0.7, 0.1, 0.5], np.float32)
    valid = np.array([True, True, False, True, True, True])
    jperm, jinv = jmotif.sort_rois(jnp.asarray(boxes), jnp.asarray(valid),
                                   jnp.asarray(scores), order)
    perm, inv = motif.sort_rois(torch.from_numpy(boxes), torch.from_numpy(valid),
                                torch.from_numpy(scores), order)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert perm[-1] == 2                          # the invalid slot last


# --- pair functions and losses ----------------------------------------------------

def test_spatial_pair_features_match_jax():
    """The 28-d features with the legacy +1 widths, within FN_TOL of scale."""
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 90, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 50, (12, 2))], 1).astype(np.float32)
    subj, obj = boxes[:6], boxes[6:]
    want = jrh.spatial_pair_features(jnp.asarray(subj), jnp.asarray(obj),
                                     jnp.asarray([100, 120]))
    got = rh.spatial_pair_features(torch.from_numpy(subj), torch.from_numpy(obj),
                                   (100, 120))
    assert got.shape == (6, 28) and gap(got, want) <= FN_TOL


def test_match_pair_labels_take_the_first_maximum():
    """Pair labels equal JAX's where a detection ties two gt boxes (the
    first best gt) and two gt relations share a pair (the first wins), with
    an invalid relation row."""
    det = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [50, 50, 60, 60],
                    [0, 0, 10, 10]], np.float32)
    gt = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [0, 0, 10, 10],
                   [50, 50, 60, 60]], np.float32)
    rels = np.array([[0, 1, 2], [0, 1, 3], [1, 3, 1], [2, 1, 2], [3, 0, 1]])
    rel_valid = np.array([True, True, True, True, False])
    pairs = rh.all_pairs(4).numpy()
    want = jax.jit(jrh.match_pair_labels)(jnp.asarray(pairs), jnp.asarray(det),
                                          jnp.asarray(rels), jnp.asarray(gt),
                                          jnp.asarray(rel_valid))
    got = rh.match_pair_labels(torch.from_numpy(pairs), torch.from_numpy(det),
                               torch.from_numpy(rels), torch.from_numpy(gt),
                               torch.from_numpy(rel_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(got.tolist()) == {0, 1, 2}        # (0, 1) → 2, not 3


def test_relation_loss_matches_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(12, R).astype(np.float32) * 3
    labels = np.array([0, 1, -1, 3, 2, 0, -1, 1, 0, 0, 2, 3])
    want = jrh.relation_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = rh.relation_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(float(got) - float(want)) <= FN_TOL


def test_reldn_contrastive_losses_match_jax():
    """The six contrastive losses and their gradient in the logits against
    JAX's, within FN_TOL, on pairs whose groups include empty ones (the
    segment reductions start from ±inf, so an empty group adds nothing);
    and the hand case of ``tests/test_relation_head.py``."""
    rng = np.random.RandomState(7)
    n, p, c = 6, 14, 7
    logits = rng.randn(p, R).astype(np.float32)
    pairs = rng.randint(0, n - 2, (p, 2)).astype(np.int64)   # anchors 4, 5 empty
    labels = rng.randint(-1, R, (p,))
    det_labels = rng.randint(1, c, (n,))
    valid = rng.rand(p) > 0.2
    kw = dict(num_obj_classes=c, num_rel_classes=R)

    def jsum(lg):
        out = jrh.reldn_contrastive_losses(lg, jnp.asarray(pairs),
                                           jnp.asarray(labels), jnp.asarray(valid),
                                           jnp.asarray(det_labels), n, **kw)
        return sum(out.values()), out

    (_, want), jgrad = jax.jit(jax.value_and_grad(jsum, has_aux=True))(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = rh.reldn_contrastive_losses(tl, torch.from_numpy(pairs),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(valid),
                                      torch.from_numpy(det_labels), n, **kw)
    assert set(got) == set(want)
    for k in got:
        assert abs(float(got[k].detach()) - float(want[k])) <= FN_TOL, k
    (tgrad,) = torch.autograd.grad(sum(got.values()), [tl])
    assert np.abs(tgrad.numpy() - np.asarray(jgrad)).max() <= FN_TOL
    assert any(float(v) > 0 for v in got.values())
    aff = torch.tensor([0.9, 0.3, 0.4, 0.5, 0.7])
    gid = torch.tensor([0, 0, 1, 1, 3])          # group 2 empty, 3 no positive
    pos = torch.tensor([True, False, True, False, False])
    loss = rh._grouped_margin_loss(aff, gid, pos, ~pos, 4, 0.2)
    want_hand = jrh._grouped_margin_loss(jnp.asarray(aff.numpy()),
                                         jnp.asarray(gid.numpy()),
                                         jnp.asarray(pos.numpy()),
                                         jnp.asarray(~pos.numpy()), 4, 0.2)
    assert abs(float(loss) - 0.1) <= FN_TOL
    assert abs(float(loss) - float(want_hand)) <= FN_TOL


def test_balanced_pair_sample_counts():
    """As ``tests/test_relation_head.py``'s case: ignores never sampled, at
    most bs·frac positives, all positives under the cap, at most bs in all;
    the counts JAX's, whatever the draw."""
    labels = np.array([3, 5, 0, 0, 0, 0, 0, 0, -1, -1])
    for seed in range(3):
        keep = rh.balanced_pair_sample(torch.from_numpy(labels),
                                       torch.Generator().manual_seed(seed),
                                       batch_size=6, positive_fraction=0.5).numpy()
        jkeep = np.asarray(jrh.balanced_pair_sample(
            jnp.asarray(labels), jax.random.PRNGKey(seed), 6, 0.5))
        kept = labels[keep]
        assert (kept >= 0).all() and keep.sum() <= 6 and (kept >= 1).sum() == 2
        assert (keep.sum(), (kept >= 1).sum()) == (jkeep.sum(),
                                                   (labels[jkeep] >= 1).sum())
    many = np.array([1] * 8 + [0] * 8)
    keep = rh.balanced_pair_sample(torch.from_numpy(many),
                                   torch.Generator().manual_seed(0), 6, 0.5)
    assert int((keep & torch.from_numpy(many >= 1)).sum()) == 3 and int(keep.sum()) == 6


# --- SceneParser over a VG-TSV fixture -------------------------------------------------

@functools.lru_cache(maxsize=None)
def work_dir() -> str:
    return tempfile.mkdtemp(prefix="test_torch_scene_graph_")


@functools.lru_cache(maxsize=None)
def fixture_yaml() -> str:
    """Two images with four objects and three relations each
    (``data/vg_tsv.write_detection_tsv``)."""
    yy, xx = np.mgrid[0:64, 0:64]
    images, labels = {}, {}
    for i in range(2):
        images[f"im{i}"] = np.stack([(yy * 3 + i * 40) % 256, (xx * 3) % 256,
                                     (yy + xx + i * 60) % 256], -1).astype(np.uint8)
        labels[f"im{i}"] = {
            "objects": [{"rect": [4, 4, 28, 28], "class": "cat", "attributes": []},
                        {"rect": [30, 30, 60, 60], "class": "dog", "attributes": []},
                        {"rect": [2, 36, 24, 62], "class": "car", "attributes": []},
                        {"rect": [34, 2, 62, 24], "class": "tree", "attributes": []}],
            "relations": [{"subj_id": 0, "obj_id": 1, "class": "on"},
                          {"subj_id": 2, "obj_id": 3, "class": "near"},
                          {"subj_id": 3, "obj_id": 1, "class": "to the left of"}]}
    return vg_tsv.write_detection_tsv(work_dir(), "val", images, labels, LABELMAP)


@functools.lru_cache(maxsize=None)
def vg_tsv_yaml() -> str:
    """``tests/test_vg_tsv.py``'s dataset (four 96×128 gradients, three
    objects and two relations each; its labelmap has this module's three
    predicates)."""
    yy, xx = np.mgrid[0:96, 0:128]
    images, labels = {}, {}
    for i in range(4):
        images[f"im{i}"] = np.stack([(yy * 2 + i * 10) % 256, (xx * 2) % 256,
                                     ((yy + xx) // 2) % 256], -1).astype(np.uint8)
        labels[f"im{i}"] = {
            "objects": [
                {"rect": [4, 4, 40, 40], "class": "cat", "attributes": ["red"]},
                {"rect": [30, 10, 90, 80], "class": "dog",
                 "attributes": ["furry", "red"]},
                {"rect": [200, 5, 300, 50], "class": "car", "attributes": []}],
            "relations": [{"subj_id": 0, "obj_id": 1, "class": "on"},
                          {"subj_id": 1, "obj_id": 2, "class": "to the left of"}]}
    labelmap = {"label_to_idx": {"cat": 1, "dog": 2, "car": 3},
                "attribute_to_idx": {"red": 1, "furry": 2},
                "predicate_to_idx": LABELMAP["predicate_to_idx"]}
    return vg_tsv.write_detection_tsv(os.path.join(work_dir(), "vg"), "train",
                                      images, labels, labelmap)


@functools.lru_cache(maxsize=None)
def checkpoint() -> str:
    path = os.path.join(work_dir(), "det.pth")
    sd = random_vinvl_state_dict(JCFG, seed=8)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


@functools.lru_cache(maxsize=None)
def detector_tree():
    return convert_detector_state_dict(random_vinvl_state_dict(JCFG, seed=8), JCFG)


@functools.lru_cache(maxsize=None)
def relation_tree(name):
    """The SceneParser subtree of ``name`` outside the detector: the head's
    flax init (and, but for RelDN, the shared stage-5 extractor's)."""
    tree = {"relation": jax_head_run(name)[0]["params"]}
    if name != "sg_reldn":
        pooled = jnp.zeros((2, CFG.roi_heads.pooler_resolution,
                            CFG.roi_heads.pooler_resolution, C4))
        tree["pred_feature_extractor"] = np_tree(
            JC5Head(JCFG.backbone).init(jax.random.PRNGKey(11), pooled))["params"]
    return tree


def four_dets(cfg):
    """The config with every one of the K slots valid."""
    return dataclasses.replace(cfg, roi_heads=dataclasses.replace(
        cfg.roi_heads, min_detections_per_img=K))


@functools.lru_cache(maxsize=None)
def jax_scene_graph(name):
    """JAX SceneParser inference over the fixture → (per-image outputs,
    sg_eval entries), as ``engine/sg_infer.evaluate_scene_graphs`` runs it."""
    cfg = four_dets(JCFG)
    model = jsp.SceneParser(cfg, num_rel_classes=R, max_rel_dets=K, algorithm=name)
    params = {"params": {"detector": detector_tree(), **relation_tree(name)}}
    h = w = cfg.input.pad_h
    anchors = jnp.asarray(jgrid_anchors(cfg.rpn, h // 16, w // 16))
    infer = jax.jit(lambda p, x, hw: model.apply(p, x, hw, anchors))
    ds = jvg.VGTSVDataset(fixture_yaml(), attribute_on=False, relation_on=True)
    outs, entries = [], []
    for i in range(len(ds)):
        img, target, _ = ds[i]
        ih, iw = min(img.shape[0], h), min(img.shape[1], w)
        canvas = np.zeros((h, w, 3), np.float32)
        canvas[:ih, :iw] = img[:h, :w]
        out = np_tree(infer(params, jnp.asarray(canvas), jnp.asarray([ih, iw])))
        outs.append(out)
        entries.append((jsg_infer.sg_gt_entry(target), jsg_infer.sg_pred_entry(out)))
    return outs, entries


def port_parser(name, cfg=None):
    model = SceneParser(cfg or four_dets(CFG), R, K, name)
    model.load_state_dict(dconv.params_from_jax(
        {"detector": detector_tree(), **relation_tree(name)}, CFG))
    return model.eval()


@pytest.mark.parametrize("name", ALGORITHMS)
def test_scene_parser_inference_matches_jax(name):
    """The port's SceneParser (one backbone pass) over the 2-image fixture:
    boxes, scores, labels, pairs and ``rel_logits`` within SP_TOL of the JAX
    module's (two passes), ``evaluate_scene_graphs``' recall dicts equal to
    ``do_sg_evaluation`` of the JAX entries (0: the random detector finds
    no gt box); and, with each image's JAX detections and three of its
    pairs taken as the ground truth (two with the JAX head's best predicate,
    one with its worst), recall equal and strictly between 0 and 1. Each
    pair keeps its best predicate, so the ranking that matters is within a
    pair: the precondition is that the best predicate's probability stands
    more than 10·SP_TOL above the second at those pairs."""
    want_outs, want_entries = jax_scene_graph(name)
    model = port_parser(name)
    h = w = CFG.input.pad_h
    anchors = torch.from_numpy(grid_anchors(CFG.rpn, h // 16, w // 16))
    ds = vg_tsv.VGTSVDataset(fixture_yaml(), attribute_on=False, relation_on=True)
    got_outs, forward = [], model.forward
    model.forward = lambda *a: got_outs.append(forward(*a)) or got_outs[-1]
    entries = sg_infer.scene_graph_entries(model, ds, anchors, (h, w))
    del model.forward
    assert len(got_outs) == len(want_outs) == 2
    trip = triplet_predictions(got_outs[0])
    jtrip = jsp.triplet_predictions(want_outs[0])
    assert sorted(trip) == sorted(jtrip) and len(trip) == K * (K - 1)
    assert max(gap(trip[k], jtrip[k]) for k in trip) <= SP_TOL
    for got, want in zip(got_outs, want_outs):
        assert int(got["pair_valid"].sum()) == K * (K - 1)
        np.testing.assert_array_equal(got["pairs"].numpy(), want["pairs"])
        for k in ("valid", "labels", "pair_valid"):
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        for k in ("boxes", "scores", "rel_logits"):
            assert gap(got[k], want[k]) <= SP_TOL, k
    assert (sg_infer.evaluate_scene_graphs(model, ds, anchors, (h, w))
            == jsg_eval.do_sg_evaluation(want_entries))

    pick = [0, 4, 9]

    def as_gt(jpred):
        scores = jpred["rel_scores"][pick, 1:]
        rels = jpred["pred_rel_inds"][pick]
        predicates = np.append(scores[:2].argmax(1), scores[2].argmin()) + 1
        n = len(jpred["pred_boxes"])
        matrix = np.zeros((n, n), np.int64)
        matrix[rels[:, 0], rels[:, 1]] = predicates
        return {"gt_boxes": jpred["pred_boxes"].astype(float),
                "gt_classes": jpred["pred_classes"],
                "gt_relations": np.column_stack([rels, predicates]),
                "pred_label_matrix": matrix}

    for _, jpred in want_entries:
        top2 = np.sort(jpred["rel_scores"][pick, 1:], axis=1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 10 * SP_TOL
    gts = [as_gt(jpred) for _, jpred in want_entries]
    got = jsg_eval.do_sg_evaluation([(g, p) for g, (_, p) in zip(gts, entries)])
    want = jsg_eval.do_sg_evaluation([(g, p) for g, (_, p) in zip(gts, want_entries)])
    assert got == want
    for metric in got.values():
        assert all(0 < v < 1 for v in metric.values()), got


# --- the tools ---------------------------------------------------------------------------

def patch_relation_init(monkeypatch, name):
    """Both packages' ``name`` heads start from ``relation_tree(name)``; the
    JAX tools' detector init returns the checkpoint's tree
    (``--checkpoint`` replaces it anyway). The trees are built first: a
    flax module made inside another's method would become its child."""
    tree = {"detector": detector_tree(), **relation_tree(name)}

    class JParser(jsp.SceneParser):
        def init(self, rngs, *args, **kw):
            return {"params": tree}

    class JDetector(jtest_tool.AttrRCNN):
        def init(self, rngs, *args, **kw):
            return {"params": tree["detector"]}

    def init_relation(self, generator):
        self.load_state_dict(dconv.params_from_jax(relation_tree(name), CFG),
                             strict=False)

    monkeypatch.setattr(jsp, "SceneParser", JParser)
    monkeypatch.setattr(jtest_tool, "AttrRCNN", JDetector)
    monkeypatch.setattr(SceneParser, "init_relation", init_relation)


def test_test_detector_sg_matches_jax(monkeypatch):
    """``test_detector --tiny --sg`` over ``tests/test_vg_tsv.py``'s dataset
    (RelDN, the detector from one ``--checkpoint``, the relation head at
    one init): the results equal the JAX ``main``'s, detection and
    ``sg_<protocol>_<k>`` alike."""
    patch_relation_init(monkeypatch, "sg_reldn")
    flags = ["--tiny", "--dtype", "float32", "--checkpoint", checkpoint(),
             "--tsv", vg_tsv_yaml(), "--sg", "--max_rel_dets", str(K)]
    want, want_ok = jtest_tool.main(flags)
    got, ok = test_tool.main(flags + ["--device", "cpu"])
    assert ok and want_ok and sorted(got) == sorted(want)
    assert any(k.startswith("sg_rowan_") for k in got)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-6, k


def _jax_train(name, steps, out_dir):
    params, loss = jtrain_tool.main(
        ["--tiny", "--dtype", "float32", "--checkpoint", checkpoint(), "--tsv",
         fixture_yaml(), "--sg", "--rel_algorithm", name, "--max_rel_dets",
         str(K), "--max_iter", str(steps), "--warmup_iters", "2",
         "--output_dir", out_dir])
    return np_tree(params), loss


@pytest.mark.parametrize("name", ALGORITHMS)
def test_train_detector_sg_matches_jax(monkeypatch, tmp_path, name):
    """``train_detector --tiny --sg`` (3 steps for RelDN and the motif, 1 for
    the others) against the JAX ``main`` from one checkpoint and relation
    init: the last loss within LOSS_TOL, every relation leaf within
    PARAM_TOL of scale of JAX's, the detector's leaves bit-equal to the
    checkpoint's; RelDN's saved ``scene_parser`` reloads bit-equal."""
    patch_relation_init(monkeypatch, name)
    steps = 3 if name in ("sg_reldn", "sg_nm") else 1
    want_params, want_loss = _jax_train(name, steps, str(tmp_path / "jax"))
    out = tmp_path / "port" if name == "sg_reldn" else ""
    parser, losses = train_tool.main(
        ["--tiny", "--dtype", "float32", "--checkpoint", checkpoint(), "--tsv",
         fixture_yaml(), "--sg", "--rel_algorithm", name, "--max_rel_dets",
         str(K), "--max_iter", str(steps), "--warmup_iters", "2", "--device",
         "cpu", "--output_dir", str(out)])
    assert len(losses) == steps and abs(losses[-1] - want_loss) <= LOSS_TOL
    want_sd = dconv.params_from_jax(want_params, CFG)
    got_sd = parser.state_dict()
    start = relation_tree(name)
    moved = 0
    for k, v in dconv.params_from_jax(start, CFG).items():
        assert gap(got_sd[k], want_sd[k]) <= PARAM_TOL, k
        moved += not torch.equal(got_sd[k], v)
    assert moved > 0
    det = dconv.load_vinvl_checkpoint(checkpoint(), CFG)
    for k, v in det.items():
        assert torch.equal(got_sd[f"detector.{k}"], v), k
    if name == "sg_reldn":
        fresh = {k: torch.zeros_like(v) for k, v in got_sd.items()}
        saved = ckpt_lib.restore_checkpoint(str(out), {"params": fresh})["params"]
        assert all(torch.equal(saved[k], got_sd[k]) for k in got_sd)


def test_phase17_dry_run():
    """``chip_smoke.run_scene_graph`` at the tiny size on the CPU: every
    reading is taken; what fails is only what needs the card (the kernel
    launches) or the full width (the tiny heads' named faults move their
    logits less than the full-width tolerances)."""
    import ast

    import chip_smoke as cs

    with pytest.raises(AssertionError) as e:
        cs.run_scene_graph(cs.kernel_counters(), "cpu", [], torch.device("cpu"),
                           tiny=True)
    failures = ast.literal_eval(e.value.args[0][len("phase 17: "):])
    assert failures and all("launches" in f or "a fault passes" in f
                            for f in failures), failures
    assert any("launches" in f for f in failures)
