"""Detector training in the port against the JAX package on the CPU, in f32
at ``tiny_detector_config``: K1's and K2's ``autograd.Function`` gradients
against ``jax.vjp`` of the JAX kernels' backward formulations, the losses,
``select_proposals(is_train=True)``, ``AttrRCNNTrainer``'s loss dict and
gradients against ``jax.grad``, the solver against optax (SGD with bias
doubling, ADAMW), the bias groups and the freeze mask leaf by leaf, the
frozen leaves' decay, and ``train_detector.main`` against the JAX ``main``
(with its resume and refusals).

Random draws cannot be shared, so the trainer and tool comparisons patch
both packages' ``losses.balanced_sample`` with one deterministic pick (the
first positives and negatives by index). The port pools through K2, whose
VJP gives the RoIs no gradient, as the JAX kernel's custom VJP does; the
JAX trainer pools through XLA's ``roi_align``, whose gradient reaches the
RoIs and, through the proposals, the RPN's box deltas. Those comparisons
stop that gradient on the JAX side (``heads.roi_align`` patched), and
:func:`test_jax_trainer_passes_a_roi_gradient` shows the difference it
removes (ROADMAP, "Known and kept on purpose")."""
import dataclasses
import functools
import operator
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpt_tpu.engine import detector_train as jdt
from cpt_tpu.engine import solver as jsolver
from cpt_tpu.models.detector import heads as jheads
from cpt_tpu.models.detector import losses as jL
from cpt_tpu.models.detector.attr_rcnn import AttrRCNNTrainer as JTrainer
from cpt_tpu.models.detector.config import tiny_detector_config as jtiny
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.models.detector.rpn import grid_anchors as jgrid_anchors
from cpt_tpu.models.detector.rpn import select_proposals as jselect
from cpt_tpu.ops.grouped_conv import \
    reference_grouped_conv3x3 as jref_conv
from cpt_tpu.ops.roi_align_pallas import _xla_pool
from cpt_tpu.ops.roi_align_pallas import batched_roi_align as jbatched_pool
from cpt_tpu.tools import train_detector as jtool
from cpt_tpu_torch.engine import detector_train as dt
from cpt_tpu_torch.engine import solver
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector import losses as L
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNNTrainer
from cpt_tpu_torch.models.detector.config import tiny_detector_config
from cpt_tpu_torch.models.detector.rpn import grid_anchors, select_proposals
from cpt_tpu_torch.ops.grouped_conv import grouped_conv3x3
from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align
from cpt_tpu_torch.tools import train_detector
from test_torch_distributed import multi_process_env
from test_torch_watchdog import guards

guard_module, guard_case = guards(600)

GRAD_TOL = 1e-5         # K1 / K2 gradients, as a fraction of their scale
LOSS_ATOL = 1e-6        # losses.* on the same samples
TRAINER_LOSS_TOL = 1e-5
TRAINER_GRAD_TOL = 1e-4  # relative to each leaf's largest JAX gradient
OPT_ATOL = 1e-6
TOOL_LOSS_TOL = 1e-4
G = 4                    # gt slots


def first_pick(xp):
    """``balanced_sample`` with the first positives and negatives by index
    (``xp``: jnp or torch), for both packages."""
    def pick(matches, rng, batch_size, positive_fraction, valid=None):
        pos, neg = matches >= 0, matches == -1
        if valid is not None:
            pos, neg = pos & valid, neg & valid
        num_pos = xp.minimum(pos.sum(), xp.asarray(int(batch_size * positive_fraction)))
        num_neg = xp.minimum(neg.sum(), batch_size - num_pos)
        return (pos & (xp.cumsum(pos, 0) <= num_pos),
                neg & (xp.cumsum(neg, 0) <= num_neg))
    return pick


@pytest.fixture
def deterministic(monkeypatch):
    """Both packages' samplers patched with the first-index pick, the JAX
    pooler's RoI gradient stopped."""
    monkeypatch.setattr(jL, "balanced_sample", first_pick(jnp))
    monkeypatch.setattr(L, "balanced_sample", first_pick(torch))
    monkeypatch.setattr(jheads, "roi_align", stopped_roi_align)


def grad_gap(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("affine", [True, False])
def test_grouped_conv_gradients_match_jax_vjp(stride, affine):
    """K1's backward (dx, dw and, fused, dscale / dbias) against ``jax.vjp``
    of ``reference_grouped_conv3x3``, the JAX kernel's backward."""
    rng = np.random.RandomState(stride + 2 * affine)
    x = rng.randn(2, 9, 11, 32).astype(np.float32)
    w = (rng.randn(3, 3, 8, 32) * 0.2).astype(np.float32)
    s, b = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    ins = [x, w] + ([s, b] if affine else [])

    def jfn(*a):
        return jref_conv(a[0], a[1], a[2] if affine else None,
                         a[3] if affine else None, 4, stride, True)

    out, vjp = jax.vjp(jfn, *map(jnp.asarray, ins))
    g = rng.randn(*out.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    y = grouped_conv3x3(tins[0], tins[1], *(tins[2:] if affine else (None, None)),
                        groups=4, stride=stride, relu=True)
    assert type(y.grad_fn).__name__ == "_GroupedConvBackward"
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), atol=1e-5)
    got = torch.autograd.grad(y, tins, torch.from_numpy(g))
    for a, e in zip(got, want):
        assert grad_gap(a, e) <= GRAD_TOL


def test_roi_align_gradients_match_jax_vjp():
    """K2's backward: ``feats`` by ``jax.vjp`` of ``_xla_pool`` (the JAX
    kernel's backward), the RoIs zero as its custom VJP gives them."""
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 12, 14, 16).astype(np.float32)
    xy = rng.uniform(0, 150, (5, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 90, (5, 2))], 1).astype(np.float32)
    kw = dict(spatial_scale=1 / 8, pooled=4, sampling=0, max_sampling=8)
    out, vjp = jax.vjp(lambda f: _xla_pool(f, jnp.asarray(rois), **kw),
                       jnp.asarray(feats))
    g = rng.randn(*out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    _, jvjp = jax.vjp(lambda f, r: jbatched_pool(f, r, 1 / 8, 4, 0, 8, "xla"),
                      jnp.asarray(feats), jnp.asarray(rois))
    assert not np.asarray(jvjp(jnp.asarray(g))[1]).any()
    f = torch.tensor(feats, requires_grad=True)
    r = torch.tensor(rois, requires_grad=True)
    y = batched_roi_align(f, r, 1 / 8, 4, 0, 8)
    assert type(y.grad_fn).__name__ == "_BatchedRoIAlignBackward"
    df, dr = torch.autograd.grad(y, [f, r], torch.from_numpy(g))
    assert grad_gap(df, want) <= GRAD_TOL
    assert not dr.any()


def loss_inputs():
    """One image's RPN and box-head inputs: anchors of a 4×4 grid, two gt
    boxes (a third slot invalid), objectness, deltas, proposals, logits."""
    rng = np.random.RandomState(11)
    anchors = jgrid_anchors(jtiny().rpn, 4, 4)
    n = anchors.shape[0]
    gt = np.array([[4, 4, 30, 30], [20, 10, 60, 40], [0, 0, 5, 5], [0] * 4],
                  np.float32)
    xy = rng.uniform(0, 50, (40, 2))
    props = np.concatenate([xy, xy + rng.uniform(2, 30, (40, 2))], 1)
    return {"anchors": anchors, "obj": rng.randn(n).astype(np.float32),
            "deltas": (rng.randn(n, 4) * 0.1).astype(np.float32),
            "gt": gt, "gt_valid": np.array([True, True, False, False]),
            "gt_labels": np.array([3, 5, 1, 0]),
            "props": props.astype(np.float32),
            "prop_valid": rng.rand(40) > 0.2,
            "logits": rng.randn(12, 7).astype(np.float32),
            "box_deltas": rng.randn(12, 28).astype(np.float32),
            "labels": np.array([0, 3, 5, 0, 1, 6, 2, 0, 4, 4, 0, 5]),
            "attr_logits": rng.randn(12, 5).astype(np.float32),
            "gt_attrs": np.array([[1, 3, 0], [0, 0, 0], [2, 2, 4], [4, 0, 0]] * 3),
            "masks": rng.rand(3, 12) > 0.4}


@pytest.mark.parametrize("name", ["match_proposals", "match_low_quality",
                                  "smooth_l1", "rpn_loss",
                                  "subsample_proposals", "fast_rcnn_loss",
                                  "attribute_loss"])
def test_losses_match_jax(name, deterministic):
    """``losses.*`` within LOSS_ATOL of the JAX functions on the same
    inputs (the samplers' first-index pick in both)."""
    x = loss_inputs()
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    if name.startswith("match"):
        iou = np.random.RandomState(3).rand(3, 30).astype(np.float32)
        iou[1, 4] = iou[1].max()            # a tie at a gt's best
        low = name == "match_low_quality"
        want = jL.match_proposals(jnp.asarray(iou), 0.7, 0.3, low,
                                  J["gt_valid"][:3])
        got = L.match_proposals(torch.from_numpy(iou), 0.7, 0.3, low,
                                T["gt_valid"][:3])
        pairs = [(got, want)]
    elif name == "smooth_l1":
        pairs = [(L.smooth_l1(T["deltas"], T["deltas"] * 0.5, 1 / 9),
                  jL.smooth_l1(J["deltas"], J["deltas"] * 0.5, 1 / 9))]
    elif name == "rpn_loss":
        args = ("obj", "deltas", "anchors", "gt", "gt_valid")
        pairs = list(zip(L.rpn_loss(*(T[a] for a in args), None,
                                    batch_size_per_image=16),
                         jL.rpn_loss(*(J[a] for a in args), None,
                                     batch_size_per_image=16)))
    elif name == "subsample_proposals":
        args = ("props", "prop_valid", "gt", "gt_labels", "gt_valid")
        pairs = list(zip(L.subsample_proposals(*(T[a] for a in args), None,
                                               batch_size_per_image=16),
                         jL.subsample_proposals(*(J[a] for a in args), None,
                                                batch_size_per_image=16)))
    elif name == "fast_rcnn_loss":
        targets = x["box_deltas"][:, :4]
        pairs = list(zip(
            L.fast_rcnn_loss(T["logits"], T["box_deltas"], T["labels"],
                             torch.from_numpy(targets), T["masks"][0] & T["masks"][1],
                             T["masks"][1], num_classes=7),
            jL.fast_rcnn_loss(J["logits"], J["box_deltas"], J["labels"],
                              jnp.asarray(targets), J["masks"][0] & J["masks"][1],
                              J["masks"][1], num_classes=7)))
    else:
        pairs = [(L.attribute_loss(T["attr_logits"], T["gt_attrs"], T["masks"][2]),
                  jL.attribute_loss(J["attr_logits"], J["gt_attrs"], J["masks"][2]))]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def test_balanced_sample_counts_and_fraction():
    """The port's own sampler: at most bs·frac positives, at most bs in
    all, only eligible entries, BETWEEN never; a different draw by seed."""
    matches = torch.tensor([0, 1, -1, -1, -1, -1, 2, -2, 3, -1, 4, 5])
    masks = []
    for seed in range(4):
        pos, neg = L.balanced_sample(matches, torch.Generator().manual_seed(seed),
                                     batch_size=6, positive_fraction=0.5)
        assert int(pos.sum()) == 3 and int(neg.sum()) == 3
        assert not (pos & neg).any() and not pos[7] and not neg[7]
        assert (matches[pos] >= 0).all() and (matches[neg] == -1).all()
        masks.append((pos.tolist(), neg.tolist()))
    assert len(set(map(str, masks))) > 1
    valid = torch.ones(12, dtype=torch.bool)
    valid[:2] = False
    pos, neg = L.balanced_sample(matches, torch.Generator().manual_seed(0), 64,
                                 0.25, valid)
    assert int(pos.sum()) == 4 and int(neg.sum()) == 5 and not pos[:2].any()


def test_select_proposals_train_sizes_match_jax():
    """``is_train`` takes ``pre/post_nms_top_n_train``: the same boxes,
    scores and validity as JAX's at a train size that cuts the pre-NMS
    set."""
    cfg = dataclasses.replace(tiny_detector_config().rpn,
                              pre_nms_top_n_train=60, post_nms_top_n_train=24)
    jcfg = dataclasses.replace(jtiny().rpn, pre_nms_top_n_train=60,
                               post_nms_top_n_train=24)
    rng = np.random.RandomState(5)
    obj = rng.randn(4, 4, 6).astype(np.float32)
    deltas = (rng.randn(4, 4, 24) * 0.3).astype(np.float32)
    anchors = grid_anchors(cfg, 4, 4)
    got = select_proposals(cfg, torch.from_numpy(obj), torch.from_numpy(deltas),
                           torch.from_numpy(anchors), (60, 64), is_train=True)
    want = jselect(jcfg, jnp.asarray(obj), jnp.asarray(deltas),
                   jnp.asarray(anchors), jnp.asarray([60, 64]), is_train=True)
    assert got[0].shape == (24, 4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy().astype(np.float32),
                                   np.asarray(b).astype(np.float32), atol=1e-4)
    test = select_proposals(cfg, torch.from_numpy(obj), torch.from_numpy(deltas),
                            torch.from_numpy(anchors), (60, 64))
    assert test[0].shape == (cfg.post_nms_top_n_test, 4)


def trainer_batch(seed: int = 0):
    """The JAX tool's synthetic sample at the tiny canvas."""
    rng = np.random.RandomState(seed)
    cfg = jtiny()
    h = w = cfg.input.pad_h
    image = rng.randn(h, w, 3).astype(np.float32) * 30
    boxes = np.zeros((G, 4), np.float32)
    boxes[:2] = [[8, 8, 40, 40], [50, 20, 60, 60]]
    labels = np.array([1, 2, 0, 0])
    valid = np.array([True, True, False, False])
    attrs = np.zeros((G, 16), np.int64)
    attrs[0, 0], attrs[1, 0] = 1, 2
    anchors = jgrid_anchors(cfg.rpn, h // 16, w // 16)
    return image, np.array([h, w]), boxes, labels, valid, attrs, anchors


@functools.lru_cache(maxsize=None)
def detector_sd():
    return random_vinvl_state_dict(jtiny(), seed=5)


JAX_ROI_ALIGN = jheads.roi_align


def stopped_roi_align(f, rois, **kw):
    return JAX_ROI_ALIGN(f, jax.lax.stop_gradient(rois), **kw)


@functools.lru_cache(maxsize=None)
def jax_trainer_step(stop_roi_grad: bool):
    """The JAX trainer's loss dict and gradient tree on ``trainer_batch``,
    the first-index pick patched in and the pooler's RoI gradient stopped
    or (``stop_roi_grad`` False) as JAX computes it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jL, "balanced_sample", first_pick(jnp))
    mp.setattr(jheads, "roi_align",
               stopped_roi_align if stop_roi_grad else JAX_ROI_ALIGN)
    try:
        params = {"params": convert_detector_state_dict(detector_sd(), jtiny())}
        model = JTrainer(jtiny())
        batch = [jnp.asarray(a) for a in trainer_batch()]

        def loss(p):
            out = model.apply(p, *batch, jax.random.PRNGKey(0))
            return sum(out.values()), out

        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return ({k: float(v) for k, v in losses.items()},
                jax.tree_util.tree_map(np.asarray, grads))
    finally:
        mp.undo()


def port_trainer_step():
    model = AttrRCNNTrainer(tiny_detector_config())
    model.load_state_dict(dconv.state_from_reference(detector_sd(),
                                                     tiny_detector_config()))
    for p in model.parameters():
        p.requires_grad_(True)
    batch = [torch.from_numpy(np.asarray(a)) for a in trainer_batch()]
    losses = model(*batch, torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(sum(losses.values()),
                                [p for _, p in model.named_parameters()],
                                allow_unused=True)
    return losses, dict(zip(names, grads))


def test_trainer_loss_dict_and_gradients_match_jax(deterministic):
    """``AttrRCNNTrainer``'s five losses within TRAINER_LOSS_TOL of the JAX
    trainer's and every parameter's gradient within TRAINER_GRAD_TOL of
    ``jax.grad``'s, relative to that leaf's largest."""
    want_losses, want_grads = jax_trainer_step(True)
    losses, grads = port_trainer_step()
    assert set(losses) == set(want_losses)
    for k, v in losses.items():
        v = v.detach()
        assert abs(float(v) - want_losses[k]) <= TRAINER_LOSS_TOL * max(
            1.0, abs(want_losses[k])), (k, float(v), want_losses[k])
    assert want_losses["loss_classifier"] > 0 and want_losses["loss_attribute"] > 0
    want = dconv.params_from_jax(want_grads, tiny_detector_config())
    gaps = {n: grad_gap(torch.zeros_like(want[n]) if g is None else g, want[n])
            for n, g in grads.items()}
    assert max(gaps.values()) <= TRAINER_GRAD_TOL, sorted(
        gaps.items(), key=lambda kv: -kv[1])[:5]
    # the backbone's grouped convs and both stage-5 heads get gradients
    assert float(grads["backbone.layer3.block_0.conv2.weight"].abs().max()) > 0
    head = grads["attr_extractor.head.layer4.block_2.conv2.weight"]
    assert float(head.abs().max()) > 0


def test_jax_trainer_passes_a_roi_gradient():
    """The difference the comparisons above remove: the JAX trainer's XLA
    pooler passes a gradient to the RoIs, so its RPN box deltas get one the
    port's (K2's zero RoI gradient, as the JAX kernel's) does not."""
    with_roi = jax_trainer_step(False)[1]
    without = jax_trainer_step(True)[1]
    a = np.asarray(with_roi["params"]["rpn"]["bbox_pred"]["kernel"])
    b = np.asarray(without["params"]["rpn"]["bbox_pred"]["kernel"])
    assert np.abs(a - b).max() > 1e-3 * np.abs(b).max()
    # the box predictor's gradient does not depend on it
    np.testing.assert_allclose(
        with_roi["params"]["box_predictor"]["cls_score"]["kernel"],
        without["params"]["box_predictor"]["cls_score"]["kernel"], atol=1e-6)


def test_warmup_multistep_lr_matches_jax():
    """The schedule at and around the warmup end and each milestone, linear
    and constant warmup."""
    for method in ("linear", "constant"):
        cfg = dataclasses.replace(solver.SolverConfig(), warmup_iters=5,
                                  steps=(8, 12), warmup_method=method)
        jcfg = dataclasses.replace(jsolver.SolverConfig(), warmup_iters=5,
                                   steps=(8, 12), warmup_method=method)
        ours = solver.warmup_multistep_lr(cfg)
        theirs = jsolver.warmup_multistep_lr(jcfg)
        for s in (0, 1, 4, 5, 6, 7, 8, 9, 11, 12, 13, 50):
            assert ours(s) == np.float32(theirs(s)), (method, s)


def jax_tree():
    return {"params": convert_detector_state_dict(detector_sd(), jtiny())}


def port_leaves():
    model = AttrRCNNTrainer(tiny_detector_config())
    model.load_state_dict(dconv.state_from_reference(detector_sd(),
                                                     tiny_detector_config()))
    return model, *dt.detector_leaves(model)


def at_path(tree, path):
    return functools.reduce(operator.getitem, path, tree["params"])


def test_jax_paths_bias_groups_and_freeze_mask_leaf_by_leaf():
    """Every port leaf's ``jax_path`` reaches the JAX leaf that
    ``params_from_jax`` carries into it; the solver's bias groups and the
    freeze mask on those paths equal the JAX package's, leaf by leaf (the
    FrozenBN scales outside the bias group, as ``"bn" in path[-2:]``
    gives)."""
    tree = jax_tree()
    model, names, leaves = port_leaves()
    carried = dconv.params_from_jax(tree, tiny_detector_config())
    assert sorted(carried) == sorted(names)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree["params"])
    assert len(flat) == len(names)
    jbias = {tuple(k.key for k in p): jsolver._is_bias(tuple(k.key for k in p))
             for p, _ in flat}
    jfreeze = jdt.freeze_mask(tree["params"])
    tx = solver.build_detector_optimizer([dconv.jax_path(n) for n in names],
                                         solver.SolverConfig())
    mask = dt.freeze_mask(names)
    for name, is_bias in zip(names, tx.bias):
        path = dconv.jax_path(name)
        leaf = np.asarray(at_path(tree, path))
        assert leaf.size == carried[name].numel(), name
        assert is_bias == jbias[path], name
        assert mask[name] == at_path({"params": jfreeze}, path), name
    assert not tx.bias[names.index("backbone.layer2.block_0.bn2.scale")]
    assert tx.bias[names.index("backbone.layer2.block_0.bn2.bias")]
    assert not mask["backbone.stem.conv1.weight"]
    assert not mask["backbone.layer1.block_0.conv2.weight"]
    assert mask["backbone.layer2.block_0.conv2.weight"]
    assert not mask["box_extractor.head.layer4.block_0.bn1.scale"]


@pytest.mark.parametrize("optimizer", ["SGD", "ADAMW"])
def test_detector_optimizer_matches_optax(optimizer):
    """Three steps of ``build_detector_optimizer`` (through a warmup end and
    a milestone) on the same gradients, the frozen leaves' zeroed as the
    JAX step zeroes them: every leaf within OPT_ATOL of optax's. A frozen
    FrozenBN scale and the stem's kernel decay (they move) while a frozen
    FrozenBN bias does not, as in JAX."""
    cfg = dataclasses.replace(solver.SolverConfig(), warmup_iters=2, steps=(2,),
                              base_lr=0.05, optimizer=optimizer)
    jcfg = jsolver.SolverConfig(**dataclasses.asdict(cfg))
    tree = jax_tree()
    model, names, leaves = port_leaves()
    start = {n: t.clone() for n, t in zip(names, leaves)}
    mask = dt.freeze_mask(names)
    jmask = jdt.freeze_mask(tree["params"])
    tx = solver.build_detector_optimizer([dconv.jax_path(n) for n in names], cfg)
    state = tx.init(leaves)
    jtx = jsolver.build_detector_optimizer(tree["params"], jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    jstate = jtx.init(jparams)
    rng = np.random.RandomState(4)
    for _ in range(3):
        jgrads = jax.tree_util.tree_map(
            lambda p, t: jnp.asarray(rng.randn(*np.shape(p)).astype(np.float32)
                                     * 0.1) if t else jnp.zeros_like(p),
            jparams, jmask)
        grads = dconv.params_from_jax({"params": jgrads}, tiny_detector_config())
        tx.update([grads[n] if mask[n] else None for n in names], state, leaves)
        upd, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    want = dconv.params_from_jax({"params": jparams}, tiny_detector_config())
    for n, t in zip(names, leaves):
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=0,
                                   atol=OPT_ATOL, err_msg=n)
    for n in ("backbone.stem.conv1.weight", "backbone.layer2.block_0.bn2.scale"):
        assert not torch.equal(leaves[names.index(n)], start[n]), n
    n = "backbone.layer2.block_0.bn2.bias"
    assert torch.equal(leaves[names.index(n)], start[n])


@functools.lru_cache(maxsize=None)
def detector_checkpoint() -> str:
    path = os.path.join(tempfile.mkdtemp(prefix="det_ckpt_"), "vinvl.pth")
    torch.save({k: torch.from_numpy(v) for k, v in detector_sd().items()}, path)
    return path


class Recorder:
    """Stands for ``MetricLogger`` in a ``do_train``: records each step's
    total and losses."""

    runs = []

    def __init__(self):
        self.steps = []
        Recorder.runs.append(self.steps)

    def update(self, time=None, **kw):
        self.steps.append(kw)

    def log_line(self, it, max_iter):
        return f"it {it}"


TOOL = ["--tiny", "--synthetic", "1", "--dtype", "float32"]


@functools.lru_cache(maxsize=None)
def jax_tool_losses(max_iter: int):
    mp = pytest.MonkeyPatch()
    mp.setattr(jL, "balanced_sample", first_pick(jnp))
    mp.setattr(jheads, "roi_align", stopped_roi_align)
    mp.setattr(jdt, "MetricLogger", Recorder)
    try:
        out = tempfile.mkdtemp(prefix="jax_det_")
        jtool.main(TOOL + ["--max_iter", str(max_iter), "--output_dir", out,
                           "--checkpoint", detector_checkpoint()])
        return Recorder.runs[-1]
    finally:
        mp.undo()


def port_tool(monkeypatch, argv):
    monkeypatch.setattr(L, "balanced_sample", first_pick(torch))
    monkeypatch.setattr(dt, "MetricLogger", Recorder)
    state = train_detector.main(TOOL + ["--device", "cpu", "--checkpoint",
                                        detector_checkpoint()] + argv)
    return state, Recorder.runs[-1]


def test_train_detector_main_matches_jax(monkeypatch, tmp_path):
    """``train_detector --tiny --synthetic 1 --max_iter 3`` against the JAX
    ``main`` from one checkpoint: each step's total and five losses within
    TOOL_LOSS_TOL, and the ``model_final`` checkpoint written."""
    want = jax_tool_losses(3)
    state, got = port_tool(monkeypatch, ["--max_iter", "3", "--output_dir",
                                         str(tmp_path)])
    assert state.step == 3 and len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            ref = float(w[k])
            assert abs(g[k] - ref) <= TOOL_LOSS_TOL * max(1.0, abs(ref)), (
                k, g[k], ref)
    assert (tmp_path / "model_final").is_dir()


def test_train_detector_resume_equals_uninterrupted(monkeypatch, tmp_path):
    """A run cut at step 2 and resumed to 4 (it skips the batches the first
    run took) ends on the leaves and optimizer state of the uninterrupted
    run, bit for bit (one thread: multi-threaded CPU BLAS is not
    bit-reproducible run to run)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole, steps = port_tool(monkeypatch, ["--max_iter", "4", "--output_dir",
                                               str(tmp_path / "a")])
        cut = ["--output_dir", str(tmp_path / "b")]
        port_tool(monkeypatch, cut + ["--max_iter", "2"])
        resumed, tail = port_tool(monkeypatch, cut + ["--max_iter", "4"])
    finally:
        torch.set_num_threads(old)
    assert resumed.step == whole.step == 4 and tail == steps[2:]
    for a, b in zip(resumed.params, whole.params):
        assert torch.equal(a, b)
    for a, b in zip(resumed.opt_state.trace, whole.opt_state.trace):
        assert torch.equal(a, b)


def test_train_detector_refusals(monkeypatch, tmp_path):
    """``--sg`` (the SceneParser) named item 7 until the scene-graph slice
    ported it: now it trains the relation head over a VG-TSV with
    relations (2 steps, finite losses, the detector's leaves unchanged;
    ``tests/test_torch_scene_graph.py`` holds it to JAX) and still asks
    for ``--tsv``. A multi-process launch named item 9 until the process
    runtime was ported: the run now goes on under one
    (``test_torch_distributed.multi_process_env``). The sharded batched
    step named item 9(b) until the meshes were ported: it now runs
    (``test_sharded_batched_step_matches_one_process``)."""
    from cpt_tpu_torch.data import vg_tsv

    yaml_path = vg_tsv.write_detection_tsv(
        str(tmp_path), "rel", {"im0": np.full((64, 64, 3), 90, np.uint8)},
        {"im0": {"objects": [{"rect": [4, 4, 30, 30], "class": "cat"},
                             {"rect": [20, 24, 60, 60], "class": "dog"}],
                 "relations": [{"subj_id": 0, "obj_id": 1, "class": "on"}]}},
        {"label_to_idx": {"cat": 1, "dog": 2}, "predicate_to_idx": {"on": 1}})
    sg = ["--tiny", "--dtype", "float32", "--device", "cpu", "--sg",
          "--max_rel_dets", "4", "--max_iter", "2", "--output_dir", "",
          "--checkpoint", detector_checkpoint()]
    calls = multi_process_env(monkeypatch)
    parser, losses = train_detector.main(sg + ["--tsv", yaml_path])
    assert calls == [True]
    assert len(losses) == 2 and all(np.isfinite(losses))
    start = dconv.load_vinvl_checkpoint(detector_checkpoint(), tiny_detector_config())
    got = parser.detector.state_dict()
    assert all(torch.equal(got[k], v) for k, v in start.items())
    with pytest.raises(SystemExit, match="--sg requires --tsv"):
        train_detector.main(sg)


SHARDED_STEP = r'''
import json
import numpy as np
import torch
from cpt_tpu_torch.engine import detector_train as dt, solver
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNNTrainer
from cpt_tpu_torch.models.detector.config import tiny_detector_config
from cpt_tpu_torch.parallel import distributed as D, mesh as M

assert D.initialize_from_env()
pid = D.process_index()
data = dict(np.load("batch.npz"))
batch = [torch.from_numpy(data[k]) for k in
         ("image", "hw", "boxes", "labels", "valid", "attrs", "anchors")]


def run(mesh):
    model = AttrRCNNTrainer(tiny_detector_config())
    model.load_state_dict(torch.load("sd.pt"))
    names, leaves = dt.detector_leaves(model)
    tx = solver.build_detector_optimizer([dconv.jax_path(n) for n in names],
                                         solver.SolverConfig(warmup_iters=0))
    state = dt.TrainState(params=leaves, opt_state=tx.init(leaves))
    step = dt.make_detector_train_step_batched(model, tx, dt.freeze_mask(names),
                                               mesh)
    totals = []
    for it in range(2):
        state, total, losses = step(state, batch,
                                    torch.Generator().manual_seed(it))
        totals.append(float(total))
    return totals, {k: float(v) for k, v in losses.items()}, dict(
        zip(names, [t.numpy() for t in state.params]))


totals, losses, params = run(M.make_mesh(dp=2, device="cpu"))
if pid == 0:
    one = run(None)
    gap = max(float(np.abs(params[k] - one[2][k]).max()
                    / max(np.abs(one[2][k]).max(), 1e-12)) for k in params)
    print(json.dumps({"pid": pid, "totals": totals, "losses": losses,
                      "one_totals": one[0], "one_losses": one[1],
                      "gap": gap}), flush=True)
else:
    print(json.dumps({"pid": pid, "totals": totals, "losses": losses}),
          flush=True)
'''


def test_sharded_batched_step_matches_one_process(tmp_path):
    """``make_detector_train_step_batched(..., mesh)`` over two images on a
    dp 2 mesh (one image a rank; each draws from its image generator, as
    in one process), two steps: both ranks' totals and loss dicts equal
    the one-process batched step's, and so do the updated leaves."""
    from test_torch_distributed import run_pair

    (b0, b1) = (trainer_batch(s) for s in (0, 1))
    np.savez(tmp_path / "batch.npz", **dict(zip(
        ("image", "hw", "boxes", "labels", "valid", "attrs"),
        [np.stack([a, b]) for a, b in zip(b0[:6], b1[:6])]),
        anchors=b0[6]))
    torch.save(dconv.state_from_reference(detector_sd(), tiny_detector_config()),
               tmp_path / "sd.pt")
    ranks = run_pair(SHARDED_STEP, tmp_path, timeout=240)
    one = ranks[0]
    assert ranks[1]["totals"] == pytest.approx(ranks[0]["totals"], rel=1e-6)
    for r in ranks:
        assert r["totals"] == pytest.approx(one["one_totals"], rel=1e-5)
        for k, v in one["one_losses"].items():
            assert r["losses"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    assert one["gap"] <= 1e-5


def test_batched_step_is_the_mean_of_single_steps(deterministic):
    """``make_detector_train_step_batched`` over two images: the loss dict
    is the mean of each image's (image ``i`` drawing from
    ``image_generator(generator, i)``), and the update that of the mean
    gradient."""
    model, names, leaves = port_leaves()
    cfg = dataclasses.replace(solver.SolverConfig(), warmup_iters=0)
    mask = dt.freeze_mask(names)
    b0, b1 = (trainer_batch(s) for s in (0, 1))
    batch = [torch.from_numpy(np.stack([a, b])) for a, b in zip(b0[:6], b1[:6])]
    batch.append(torch.from_numpy(b0[6]))
    gen = torch.Generator().manual_seed(0)
    singles = [model(*[torch.from_numpy(np.asarray(a)) for a in b],
                     dt.image_generator(gen, i)) for i, b in enumerate((b0, b1))]
    tx = solver.build_detector_optimizer([dconv.jax_path(n) for n in names], cfg)
    state = dt.TrainState(params=leaves, opt_state=tx.init(leaves))
    step = dt.make_detector_train_step_batched(model, tx, mask)
    state, total, losses = step(state, batch, gen)
    for k, v in losses.items():
        want = (singles[0][k] + singles[1][k]) / 2
        assert abs(float(v) - float(want)) <= 1e-5 * max(1.0, abs(float(want))), k
    assert state.step == 1 and state.opt_state.count == 1
