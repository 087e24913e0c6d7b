"""K2's and K5's card checks on the CPU, and the equivalence K5's kernel
rests on. Each named fault that ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold the kernels to (``chip_smoke.K2_FAULTS``,
``chip_smoke.NMS_FAULTS``) misses: K2's by more than 3× the tolerance at a
small width with a RoI that reaches past the map, K5's by a different
result on ``chip_smoke.nms_inputs``. A plain-torch model of K5's
sorted-order bitmask NMS (rank, pairwise mask words, a chunked scan that
stops early) equals the greedy loop (``nms_padded``) and the TPU kernel in
interpret mode slot for slot, and the IoU it computes once per pair is
symmetric bit for bit."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from cpt_tpu.ops.nms_pallas import nms_pallas as jax_nms_pallas
from cpt_tpu_torch.ops.nms import NEG_INF, _iou_row, nms_padded
from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align_plain
from test_torch_watchdog import guards, run_interpret

guard_module, guard_case = guards(120)

SCALE = 1 / 16.0


@functools.lru_cache(maxsize=None)
def _k2_inputs():
    """feats [2, 12, 20, 64] f32 and RoIs in image pixels: the first
    reaches past the map on every side (3 samples a bin side at 14 bins),
    the rest lie inside it (1-2 samples)."""
    rng = np.random.RandomState(11)
    feats = torch.from_numpy(rng.randn(2, 12, 20, 64).astype(np.float32))
    xy = rng.uniform(0, 200, (5, 2))
    rois = np.concatenate([xy, xy + rng.uniform(8, 120, (5, 2))], 1)
    rois[0] = [-60.0, -50.0, 500.0, 400.0]
    return feats, torch.from_numpy(rois.astype(np.float32))


@pytest.mark.parametrize("fault,sampling", [
    (f, s) for s in (0, 2) for f in cs.K2_FAULTS
    if not (f == "fixed_grid" and s)])
def test_k2_fault_misses_tolerance(fault, sampling):
    feats, rois = _k2_inputs()
    want = batched_roi_align_plain(feats, rois, SCALE, 14, sampling, 8)
    got = cs.k2_faults(feats, rois, SCALE, 14, sampling, 8)[fault]()
    tol = cs.TOL["K2"] * float(want.abs().max())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) > 3 * tol


@pytest.mark.parametrize("sampling", [0, 2])
def test_k2_fault_emulation_without_a_fault_is_the_plain_version(sampling):
    """With no fault the emulation computes the plain version itself, so
    a fault's distance is the fault's alone."""
    feats, rois = _k2_inputs()
    want = batched_roi_align_plain(feats, rois, SCALE, 14, sampling, 8)
    got = cs.roi_align_with_fault(feats, rois, SCALE, 14, sampling, 8)
    assert torch.equal(got, want)
    assert set(cs.k2_faults(feats, rois, SCALE, 14, sampling, 8)) == (
        set(cs.K2_FAULTS) - ({"fixed_grid"} if sampling else set()))
    with pytest.raises(ValueError):
        cs.roi_align_with_fault(feats, rois, SCALE, fault="no_such_fault")


@pytest.mark.parametrize("sampling", [0, 2])
@pytest.mark.parametrize("which", ["small", "request", "detect box head"])
def test_k2_bound_reads_the_plain_versions_support(which, sampling):
    """K2's bound (``chip_smoke.k2_work``) counts as read exactly the
    feature pixels that some RoI's interpolation weights reach (a nonzero
    row of Ry × a nonzero column of Rx in the plain version), each once,
    plus the RoIs and the bf16 output."""
    from cpt_tpu_torch.ops.roi_align import interp_matrices

    if which == "small":
        feats, rois = _k2_inputs()
        shape, rois = tuple(feats.shape), rois.numpy()
    else:
        _, shape, rois = next(s for s in cs.k2_shapes() if s[0] == which)
    b, h, w, c = shape
    ry, rx = interp_matrices(torch.from_numpy(rois), h, w, spatial_scale=SCALE,
                             pooled=14, sampling=sampling)
    read = ((ry > 0).any(1)[:, :, None] & (rx > 0).any(1)[:, None, :]).any(0)
    n_bytes, n_ops = cs.k2_work(shape, rois, SCALE, 14, sampling)
    out_bytes = b * len(rois) * 14 * 14 * c * 2
    assert n_bytes == b * int(read.sum()) * c * 2 + rois.nbytes + out_bytes
    assert n_ops > 0
    if which == "small":   # the first RoI covers the map
        assert bool(read.all())


def _torch_inputs(b, k, thr, offset=0.0, ones=False, seed=0):
    return tuple(map(torch.from_numpy,
                     cs.nms_inputs(b, k, thr, offset, ones, seed)))


def _same(got, want):
    return all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("fault", cs.NMS_FAULTS)
@pytest.mark.parametrize("b,k,max_out,thr,offset,ones", [
    (1, 300, 100, 0.5, 0.0, False), (3, 120, 40, 0.7, 1.0, True)])
def test_nms_fault_changes_the_result(fault, b, k, max_out, thr, offset, ones):
    boxes, scores, valid = _torch_inputs(b, k, thr, offset, ones, seed=k + b)
    want = nms_padded(boxes, scores, valid, thr, max_out, offset)
    got = cs.nms_with_fault(boxes, scores, valid, thr, max_out, fault, offset)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[0].shape == want[0].shape == (b, max_out)
    assert not _same(got, want)


def test_planted_chain_keeps_its_last_box():
    """The chain nms_inputs plants at indices 16-18: B falls to A, and C
    survives B's suppression (IoU(A, C) <= thr); ``chain`` drops C too."""
    for thr in (0.3, 0.5, 0.7):
        boxes, scores, valid = _torch_inputs(1, 19, thr)
        a, bb, c = boxes[0, 16:19]
        assert float(_iou_row(a[None], bb[None, None], 0.0)) > thr
        assert float(_iou_row(bb[None], c[None, None], 0.0)) > thr
        assert float(_iou_row(a[None], c[None, None], 0.0)) <= thr
        idx, keep = nms_padded(boxes, scores, valid, thr, 19)
        kept = idx[keep].tolist()
        assert 16 in kept and 17 not in kept and 18 in kept
        idx, keep = cs.nms_with_fault(boxes, scores, valid, thr, 19, "chain")
        assert 18 not in idx[keep].tolist()


TILE = 64


def _words(bits: np.ndarray) -> list:
    """A bool row as 64-bit words (bit t of word w: column 64 w + t)."""
    padded = np.zeros(-(-len(bits) // TILE) * TILE, bool)
    padded[:len(bits)] = bits
    return [int.from_bytes(np.packbits(padded[w:w + TILE],
                                       bitorder="little").tobytes(), "little")
            for w in range(0, len(padded), TILE)]


FULL = (1 << TILE) - 1


def _resolve_serial(avail: int, diag: list, slots: int) -> int:
    """Walk the chunk's candidates in order: keep the first, drop what it
    overlaps, repeat (at most ``slots`` kept)."""
    keep = 0
    while avail and bin(keep).count("1") < slots:
        t = (avail & -avail).bit_length() - 1
        keep |= 1 << t
        avail &= (avail - 1) & ~diag[t]
    return keep


def _resolve_rounds(avail: int, diag: list, slots: int) -> int:
    """The kernel's ``resolve_chunk``: transpose the diagonal (e[t]: the
    rows before t that overlap it), then in rounds decide every candidate
    whose earlier overlappers are all decided (kept if none is kept), and
    keep the first ``slots``."""
    e = [sum(1 << r for r in range(TILE) if diag[r] >> t & 1)
         for t in range(TILE)]
    keep, decided = 0, ~avail & FULL
    while decided != FULL:
        new_keep = new_decided = 0
        for t in range(TILE):
            if decided >> t & 1:
                continue
            if e[t] & keep:
                new_decided |= 1 << t
            elif not e[t] & ~decided & FULL:
                new_keep |= 1 << t
                new_decided |= 1 << t
        keep |= new_keep
        decided |= new_decided
    while bin(keep).count("1") > slots:
        keep &= ~(1 << (keep.bit_length() - 1))
    return keep


def bitmask_nms(boxes, scores, valid, thr, max_out, offset=0.0,
                resolve=_resolve_serial, seed=0):
    """A plain-torch model of K5 (``csrc/nms.cu``) on one problem [K]:
    rank each live box by the live boxes that beat it (higher score, then
    lower index; -0 ties +0), order them by rank, write each row's
    IoU > thr bits against the later boxes with ``_iou_row``'s arithmetic,
    then scan the order in chunks of 64: resolve a chunk from its diagonal
    words (``resolve``), OR the kept rows' later words into ``removed``,
    stop at ``max_out``. The diagonal words of rows past the last live box
    are random bits (the kernel's stale shared memory there), which a
    resolve must ignore."""
    rng = np.random.RandomState(seed)
    k = scores.shape[0]
    live = valid & (scores > NEG_INF / 2)
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    idx = torch.arange(k)
    beats = live[None, :] & ((s[None, :] > s[:, None])
                             | ((s[None, :] == s[:, None])
                                & (idx[None, :] < idx[:, None])))
    rank = beats.sum(1)
    n = int(live.sum())
    order = torch.empty(n, dtype=torch.int64)
    order[rank[live]] = idx[live]
    sb = boxes[order]
    mask = []
    for r in range(n):
        hit = (_iou_row(sb[r:r + 1], sb[None], offset)[0] > thr).numpy()
        hit[:r + 1] = False
        mask.append(_words(hit))
    chunks = -(-n // TILE)
    removed = [0] * chunks
    kept = []
    for c in range(chunks):
        if len(kept) >= max_out:
            break
        rows = min(TILE, n - c * TILE)
        avail = ~removed[c] & ((1 << rows) - 1)
        diag = [mask[c * TILE + t][c] if t < rows
                else int(rng.randint(0, 2 ** 62)) << 2 for t in range(TILE)]
        keep = resolve(avail, diag, max_out - len(kept))
        kept += [int(order[c * TILE + t]) for t in range(rows) if keep >> t & 1]
        for t in range(rows):
            if keep >> t & 1:
                for w in range(c + 1, chunks):
                    removed[w] |= mask[c * TILE + t][w]
    out_idx = torch.zeros(max_out, dtype=torch.int32)
    out_keep = torch.zeros(max_out, dtype=torch.bool)
    out_idx[:len(kept)] = torch.tensor(kept, dtype=torch.int32)
    out_keep[:len(kept)] = True
    return out_idx, out_keep


# ties and invalid boxes, exact-threshold pairs and the chain everywhere;
# several 64-box chunks; max_out above the survivors; the legacy +1 IoU;
# the random detector's scores (all 1.0); a batch
@pytest.mark.parametrize("resolve", [_resolve_serial, _resolve_rounds],
                         ids=["serial", "rounds"])
@pytest.mark.parametrize("b,k,max_out,thr,offset,ones", [
    (1, 300, 100, 0.5, 0.0, False), (1, 150, 160, 0.7, 0.0, False),
    (1, 257, 60, 0.3, 1.0, False), (1, 200, 40, 0.5, 0.0, True),
    (3, 100, 32, 0.5, 0.0, False)])
def test_bitmask_scan_equals_greedy_nms(b, k, max_out, thr, offset, ones,
                                        resolve):
    boxes, scores, valid = _torch_inputs(b, k, thr, offset, ones, seed=b + k)
    want = nms_padded(boxes, scores, valid, thr, max_out, offset)
    for p in range(b):
        got = bitmask_nms(boxes[p], scores[p], valid[p], thr, max_out, offset,
                          resolve, seed=p)
        assert _same(got, (want[0][p], want[1][p])), p
        jidx, jkeep = run_interpret(
            lambda x, y, z: jax_nms_pallas(x, y, z, thr, max_out, offset,
                                           interpret=True),
            *(jnp.asarray(a[p].numpy()) for a in (boxes, scores, valid)))
        assert np.array_equal(jkeep, got[1].numpy())
        assert np.array_equal(jidx, got[0].numpy())


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_iou_row_is_symmetric_bit_for_bit(offset):
    """IoU(a, b) == IoU(b, a) exactly, so K5's mask computes each pair's
    bit once: random f32 boxes, some empty or inverted."""
    rng = np.random.RandomState(12)
    xy = rng.uniform(-50, 500, (200, 2))
    wh = rng.uniform(-20, 300, (200, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32))
    iou = torch.stack([_iou_row(boxes[i:i + 1], boxes[None], offset)[0]
                       for i in range(len(boxes))])
    assert torch.equal(iou, iou.T)
    assert float(iou.max()) > 0.5 and float(iou.min()) == 0.0


@pytest.mark.parametrize("b,k,path", [
    (1, 300, "grid"), (1, 6000, "grid"), (1594, 300, "block"),
    (2, 1024, "block"), (2, 1025, "grid")])
def test_nms_path_rule(b, k, path):
    """K5's dispatch rule: one problem, or problems of more than
    NMS_BLOCK_K boxes, on the grid path; a batch of smaller ones a block
    each (the main path's shapes on the side the card measured faster)."""
    from cpt_tpu_torch.ops.nms_pallas import NMS_BLOCK_K, nms_path

    assert NMS_BLOCK_K == 1024
    assert nms_path(b, k) == path
