"""The caption modules of the port (``models/bert/captioning.py``,
``engine/generation.py``, ``utils/cbs.py``, ``engine/scst.py``, the untied
decoder of ``BertLMPredictionHead`` and ``utils/convert.py``) against the
JAX package's on the CPU in f32, at a tiny size (``tiny_bert_config``: 2
layers, hidden 32, vocab 192; a caption canvas of 10, 4 od-label slots, 5
regions), inputs drawn from a numpy seed and the JAX tree carried over
through ``params_from_jax``.

The tree is flax's init with the untied decoder and the MLM bias drawn
anew (std 1 and 0.5), so that the logits spread and depend on the input:
with flax's 0.02-std tables every step's logits sit within a few
thousandths of each other. A decode test asserts its own precondition,
that the smallest top-2 gap of JAX's logits along JAX's trajectory is at
least 100× the logit tolerance, so a near-tie fails loudly instead of
flaking."""
import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jtiny_bert_config
from cpt_tpu.engine import generation as jgen
from cpt_tpu.engine import scst as jscst
from cpt_tpu.models.bert import captioning as jcap
from cpt_tpu.utils import cbs as jcbs
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.engine import generation as gen
from cpt_tpu_torch.engine import scst
from cpt_tpu_torch.models.bert import captioning as cap
from cpt_tpu_torch.models.bert.heads import BertLMPredictionHead
from cpt_tpu_torch.tools import run_captioning
from cpt_tpu_torch.utils import cbs
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils import tokenization as tok
from test_torch_watchdog import guards

guard_module, guard_case = guards(420)

LA, OD, IMG, D, V = 10, 4, 5, 8, 192
# logits of the tiny model in f32, as a fraction of the largest |logit|
LOGIT_TOL = 1e-5
# loss gradients, per tensor as ‖Δg‖ / ‖g_jax‖; log-prob sums and beam
# scores absolutely (nats)
GRAD_RTOL = 1e-4
SCORE_TOL = 1e-4
LOSS_TOL = 1e-6
OD_TEXTS = ("man dog", "dog cat", "the red man")


def configs(tied: bool):
    kw = dict(vocab_size=V, img_feature_dim=D, max_position_embeddings=64,
              tie_weights=tied)
    return jtiny_bert_config(**kw), tiny_bert_config(**kw)


def tokenizers():
    return jtok.BertTokenizer(jtok.toy_vocab()), tok.BertTokenizer(tok.toy_vocab())


@functools.lru_cache(maxsize=None)
def decode_inputs():
    """Three images' decode inputs (the test tensorizer: caption slots all
    [MASK], od labels as text_b): (input_ids, segment_ids, attn [3, S, S],
    img_feats) as numpy."""
    rng = np.random.RandomState(0)
    t = jcap.CaptionTensorizer(tokenizers()[0], max_img_seq_len=IMG,
                               max_seq_len=LA + OD, max_seq_a_len=LA,
                               is_train=False)
    rows = [t.tensorize("", rng.randn(IMG - i, D).astype(np.float32),
                        text_b=od) for i, od in enumerate(OD_TEXTS)]
    return tuple(np.stack([r[j] for r in rows]) for j in range(4))


@functools.lru_cache(maxsize=None)
def train_inputs():
    """A training batch of three captions (80/10/10 masking, up to 3 masked
    slots, padding slots among them): (ids, attn, segs, feats, mpos, mids)."""
    rng = np.random.RandomState(1)
    t = jcap.CaptionTensorizer(tokenizers()[0], max_img_seq_len=IMG,
                               max_seq_len=LA + OD, max_seq_a_len=LA,
                               max_masked_tokens=3)
    py = random.Random(3)
    rows = [t.tensorize(c, rng.randn(IMG, D).astype(np.float32), text_b=od,
                        rng=py)
            for c, od in zip(("the red dog is on the left", "a cat",
                              "the man and the woman"), OD_TEXTS)]
    return tuple(np.stack([r[j] for r in rows]) for j in (0, 2, 1, 3, 4, 5))


@functools.lru_cache(maxsize=None)
def models(tied: bool):
    """(JAX model, its params, the port's model on them): flax's init with
    the decoder (untied) and the MLM bias drawn anew from seed 2."""
    jcfg, pcfg = configs(tied)
    ids, segs, attn, f = decode_inputs()
    jm = jcap.BertForImageCaptioning(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                              jnp.asarray(attn), jnp.asarray(segs),
                              jnp.asarray(f))
    rng = np.random.RandomState(2)
    inner = dict(params["params"])
    head = dict(inner["mlm_head"])
    if not tied:
        head["decoder"] = jnp.asarray(rng.randn(V, 32).astype(np.float32))
    head["bias"] = jnp.asarray(rng.randn(V).astype(np.float32) * 0.5)
    inner["mlm_head"] = head
    params = {"params": inner}
    pm = cap.BertForImageCaptioning(pcfg).eval()
    pm.load_state_dict(bconv.params_from_jax(params, pcfg, "caption"))
    return jm, params, pm


def as_jax(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def as_torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def gen_configs(**kw):
    return (jgen.GenerationConfig(max_seq_a_len=LA, **kw),
            gen.GenerationConfig(max_seq_a_len=LA, **kw))


def test_top_k_stable_keeps_jax_tie_order():
    """``top_k_stable`` gives ``jax.lax.top_k``'s values and indices (the
    lower index first among ties), on short and long rows full of ties and
    of NEG, k up to the row's length."""
    x = np.asarray([[1.0, 3.0, 3.0, -1e9, 2.0, -1e9, 3.0, -1e9]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    pv, pi = cap.top_k_stable(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert pi.tolist() == [[1, 2, 6, 4, 0, 3]]
    rng = np.random.RandomState(0)
    for n, k in ((7, 2), (7, 7), (50, 3), (1000, 10), (5000, 1), (3000, 40)):
        x = rng.randint(-3, 4, size=(3, n)).astype(np.float32)
        x[x == -3] = -1e9
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = cap.top_k_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_smoothed_caption_loss_matches_jax(ratio):
    """Label smoothing 0.1 over 12 slots of which 4 are padding (target 0),
    with and without dropping the worst half: within LOSS_TOL, and its
    gradient too."""
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 4, 17).astype(np.float32) * 3
    targets = rng.randint(1, 17, size=(3, 4)).astype(np.int32)
    targets[0, 3] = targets[1, 2:] = targets[2, 0] = 0
    want, jgrad = jax.value_and_grad(lambda x: jcap.smoothed_caption_loss(
        x, jnp.asarray(targets), 0.1, ratio))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = cap.smoothed_caption_loss(x, torch.from_numpy(targets), 0.1, ratio)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL * max(1.0, abs(float(want)))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=LOSS_TOL)


def test_tensorizer_and_mask_match_jax():
    """The copied ``CaptionTensorizer`` (train and test) and
    ``caption_attention_mask`` give the JAX package's arrays on the same
    ``random.Random`` draws."""
    jt, pt = tokenizers()
    feats = np.random.RandomState(5).randn(7, D).astype(np.float32)
    for is_train in (True, False):
        kw = dict(max_img_seq_len=IMG, max_seq_len=LA + OD, max_seq_a_len=LA,
                  max_masked_tokens=3, is_train=is_train)
        for seed in range(4):
            want = jcap.CaptionTensorizer(jt, **kw).tensorize(
                "the red dog is on the left of a man", feats, text_b="cat dog",
                rng=random.Random(seed))
            got = cap.CaptionTensorizer(pt, **kw).tensorize(
                "the red dog is on the left of a man", feats, text_b="cat dog",
                rng=random.Random(seed))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        cap.caption_attention_mask(6, 3, 2, 4, 2, 2),
        jcap.caption_attention_mask(6, 3, 2, 4, 2, 2))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked_pos", "full"])
def test_caption_forward_matches_jax(tied, masked):
    """The forward with the seq2seq mask, on every position or on the
    masked slots with the smoothed loss: logits within LOGIT_TOL of their
    scale; with masked slots the loss, and its gradient in every parameter
    within GRAD_RTOL (autograd against ``jax.grad``)."""
    jm, params, pm = models(tied)
    batch = train_inputs()
    n = 6 if masked else 4
    jargs, pargs = as_jax(*batch[:n]), as_torch(*batch[:n])
    _, want = jm.apply(params, *jargs)
    _, got = pm(*pargs)
    want = np.asarray(want)
    assert got.shape == want.shape == ((3, 3, V) if masked else (3, LA + OD + IMG, V))
    scale = float(np.abs(want).max())
    assert float(np.abs(got.detach().numpy() - want).max()) <= LOGIT_TOL * scale
    if not masked:
        return
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.apply(p, *jargs, drop_worst_ratio=0.0)[0])(params)
    loss, _ = pm(*pargs, drop_worst_ratio=0.0)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, list(pm.parameters()), allow_unused=True)
    want_g = bconv.params_from_jax(jgrads, pm.config, "caption")
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert sorted(names) == sorted(want_g)
    if not tied:
        assert "mlm_head.decoder" in names
    for name, g in zip(names, grads):
        w = want_g[name]
        g = torch.zeros_like(w) if g is None else g
        gap = float((g - w).norm()) / max(float(w.norm()), 1e-30)
        assert gap <= GRAD_RTOL or float((g - w).abs().max()) <= 1e-9, (name, gap)


def test_repetition_penalty_and_filters_exact():
    """``_apply_repetition_penalty`` (PAD excluded) and
    ``_filter_top_k_top_p`` (top-k, top-p, both) equal the JAX functions'
    output bit for bit."""
    rng = np.random.RandomState(6)
    logits = (rng.randn(4, 40) * 2).astype(np.float32)
    logits[:, 5] = logits[:, 6]        # a tie at the cut
    tokens = rng.randint(0, 40, size=(4, 7)).astype(np.int32)
    tokens[:, -2:] = 0
    for penalty in (1.0, 1.3):
        want = jgen._apply_repetition_penalty(jnp.asarray(logits),
                                              jnp.asarray(tokens), penalty, 0)
        got = gen._apply_repetition_penalty(torch.from_numpy(logits),
                                            torch.from_numpy(tokens), penalty, 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for top_k, top_p in ((0, 1.0), (5, 1.0), (0, 0.7), (8, 0.5), (1, 1.0)):
        want = jgen._filter_top_k_top_p(jnp.asarray(logits), top_k, top_p)
        got = gen._filter_top_k_top_p(torch.from_numpy(logits), top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def jax_greedy(penalty: float):
    """JAX's greedy decode (untied model, od-label ``base_ids``) and its
    per-step logits along its own trajectory [La − 1, B, V]."""
    jm, params, _ = models(False)
    ids, segs, attn, f = decode_inputs()
    jcfg, _ = gen_configs(repetition_penalty=penalty)
    toks, score = jgen.greedy_or_sample(jm, params, jcfg, *as_jax(segs, attn, f),
                                        base_ids=jnp.asarray(ids))
    toks = np.asarray(toks)
    step = jax.jit(jgen.make_step_logits_fn(jm, jcfg), static_argnums=())
    per_step = []
    for t in range(1, LA):
        prefix = toks.copy()
        prefix[:, t:] = 0
        per_step.append(np.asarray(step(params, jnp.asarray(prefix), t,
                                        *as_jax(segs, attn, f, ids))))
    return toks, np.asarray(score), np.stack(per_step)


def test_greedy_matches_jax():
    """Greedy with ``base_ids`` and repetition penalty 1.3: the port's
    per-step logits along JAX's trajectory within LOGIT_TOL of scale, the
    same tokens, log-prob sums within SCORE_TOL. Precondition: every
    step's top-2 gap (after the penalty) at least 100× the tolerance."""
    _, _, pm = models(False)
    ids, segs, attn, f = decode_inputs()
    want_tok, want_score, want_logits = jax_greedy(1.3)
    _, pcfg = gen_configs(repetition_penalty=1.3)
    step = gen.make_step_logits_fn(pm, pcfg)
    gaps = []
    with torch.no_grad():
        for t in range(1, LA):
            prefix = want_tok.copy()
            prefix[:, t:] = 0
            got = step(*as_torch(prefix), t, *as_torch(segs, attn, f, ids))
            want = want_logits[t - 1]
            scale = float(np.abs(want).max())
            assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL * scale
            pen = np.sort(np.asarray(jgen._apply_repetition_penalty(
                jnp.asarray(want), jnp.asarray(prefix), 1.3, 0)), -1)
            live = ~np.any(prefix == 102, axis=1)
            gaps += list(((pen[:, -1] - pen[:, -2]) / scale)[live])
    assert min(gaps) >= 100 * LOGIT_TOL, min(gaps)
    tokens, score = gen.greedy_or_sample(pm, pcfg, *as_torch(segs, attn, f),
                                         base_ids=as_torch(ids)[0])
    np.testing.assert_array_equal(tokens.numpy(), want_tok)
    np.testing.assert_allclose(score.numpy(), want_score, atol=SCORE_TOL)
    assert (tokens[:, 0] == 101).all() and not pm.training


def test_sampling_top_k_1_is_greedy_and_draws_from_the_generator():
    """``do_sample`` with top_k 1 gives JAX's greedy tokens; sampling at
    temperature 1.5 with top-p 0.9 is deterministic given the generator
    and follows its seed; without a generator it draws as from seed 0."""
    _, _, pm = models(False)
    ids, segs, attn, f = decode_inputs()
    want_tok, _, _ = jax_greedy(1.0)
    ctx = as_torch(segs, attn, f)
    base = as_torch(ids)[0]
    _, k1 = gen_configs(do_sample=True, top_k=1)
    tokens, _ = gen.greedy_or_sample(pm, k1, *ctx, torch.Generator().manual_seed(9),
                                     base_ids=base)
    np.testing.assert_array_equal(tokens.numpy(), want_tok)
    _, hot = gen_configs(do_sample=True, temperature=1.5, top_p=0.9)

    def draw(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return gen.greedy_or_sample(pm, hot, *ctx, g, base_ids=base)

    (a, sa), (b, sb), (c, _), (d, _) = draw(7), draw(7), draw(8), draw(None)
    assert torch.equal(a, b) and torch.equal(sa, sb) and not torch.equal(a, c)
    assert torch.equal(d, draw(0)[0]) and not np.array_equal(a.numpy(), want_tok)


@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
def test_beam_search_matches_jax(length_penalty):
    """Beam search (3 beams, 2 kept, repetition penalty 1.3): the same
    tokens, EOS appended, scores within SCORE_TOL."""
    jm, params, pm = models(False)
    ids, segs, attn, f = decode_inputs()
    jcfg, pcfg = gen_configs(num_beams=3, num_keep_best=2,
                             repetition_penalty=1.3,
                             length_penalty=length_penalty)
    want_tok, want_sc = jgen.beam_search(jm, params, jcfg, *as_jax(segs, attn, f),
                                         base_ids=jnp.asarray(ids))
    tokens, scores = gen.beam_search(pm, pcfg, *as_torch(segs, attn, f),
                                     base_ids=as_torch(ids)[0])
    assert tokens.shape == (3, 2, LA) and scores.shape == (3, 2)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_sc), atol=SCORE_TOL)
    assert (tokens == 102).any(-1).all()
    assert len({tuple(r) for r in tokens.reshape(-1, LA).tolist()}) > 1


@pytest.mark.parametrize("constraints", [[[110]], [[110], [120, 121]]],
                         ids=["one_token", "two_token"])
def test_constrained_beam_search_matches_jax(constraints):
    """CBS on one image with a one-token constraint, and with a one-token
    and a two-token phrase: the FSM equal, the same caption tokens (each
    constraint in them), the score within SCORE_TOL."""
    jm, params, pm = models(False)
    ids, segs, attn, f = (x[:1] for x in decode_inputs())
    jtrans, jnsat = jcbs.build_fsm(constraints, V)
    trans, nsat = cbs.build_fsm(constraints, V)
    np.testing.assert_array_equal(trans, jtrans)
    np.testing.assert_array_equal(nsat, jnsat)
    k = 3
    n = trans.shape[0] * k
    ctx = [np.repeat(x, n, 0) for x in (segs, attn, f, ids)]
    kw = dict(transitions=trans, num_satisfied=nsat, beams_per_state=k,
              max_len=LA, bos_id=101, eos_id=102, pad_id=0,
              min_constraints=len(constraints),
              num_group_states=1 << len(constraints))
    jcfg, pcfg = gen_configs()
    jstep = jgen.make_step_logits_fn(jm, jcfg)
    want_tok, want_sc = jax.jit(lambda p: jcbs.constrained_beam_search(
        lambda p_, t, s: jstep(p_, t, s, *as_jax(*ctx)), p, (), **kw))(params)
    tokens, score = cbs.constrained_beam_search(
        gen.make_step_logits_fn(pm, pcfg), as_torch(*ctx), **kw)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tok))
    assert abs(float(score) - float(want_sc)) <= SCORE_TOL
    row = tokens.tolist()
    for c in constraints:
        assert any(row[i:i + len(c)] == c for i in range(LA)), (row, c)


@functools.lru_cache(maxsize=None)
def jax_scst():
    """JAX's sampled captions (2 images × 3 rollouts, top-k 20), their
    teacher-forced log-probs and the SCST loss's gradient for fixed
    advantages."""
    jm, params, _ = models(False)
    ids, segs, attn, f = (np.repeat(x[:2], 3, 0) for x in decode_inputs())
    jcfg, _ = gen_configs(do_sample=True, top_k=20)
    sampled, _ = jgen.greedy_or_sample(jm, params, jcfg, *as_jax(segs, attn, f),
                                       jax.random.PRNGKey(3),
                                       base_ids=jnp.asarray(ids))
    adv = jnp.asarray(np.random.RandomState(7).randn(6).astype(np.float32))
    fn = jscst.sequence_logprob_fn(jm, jcfg)
    ctx = as_jax(segs, attn, f, ids)
    logp = fn(params, sampled, *ctx)
    grads = jax.grad(lambda p: -jnp.mean(adv * fn(p, sampled, *ctx)))(params)
    return np.asarray(sampled), np.asarray(adv), np.asarray(logp), grads


def test_sequence_logprob_and_scst_gradient_match_jax():
    """On JAX's sampled tokens: the teacher-forced log-prob sums within
    SCORE_TOL, and the gradient of −mean(adv · log P) in every parameter
    within GRAD_RTOL of ``jax.grad``."""
    sampled, adv, want_logp, jgrads = jax_scst()
    _, _, pm = models(False)
    ids, segs, attn, f = (np.repeat(x[:2], 3, 0) for x in decode_inputs())
    _, pcfg = gen_configs()
    ctx = as_torch(segs, attn, f)
    base = as_torch(ids)[0]
    with torch.no_grad():
        logp = scst.sequence_logprob_fn(pm, pcfg)(as_torch(sampled)[0], *ctx, base)
    np.testing.assert_allclose(logp.numpy(), want_logp, atol=SCORE_TOL)
    loss = scst.scst_loss(pm, pcfg, as_torch(sampled)[0], as_torch(adv)[0],
                          ctx, base)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, list(pm.parameters()), allow_unused=True)
    want = bconv.params_from_jax(jgrads, pm.config, "caption")
    for name, g in zip(names, grads):
        w = want[name]
        g = torch.zeros_like(w) if g is None else g
        gap = float((g - w).norm()) / max(float(w.norm()), 1e-30)
        assert gap <= GRAD_RTOL or float((g - w).abs().max()) <= 1e-9, (name, gap)


@pytest.mark.parametrize("baseline", ["greedy", "sample", "beam"])
def test_scst_step_rewards_and_gradient(baseline):
    """``scst_step`` with 3 rollouts and each baseline: the rewards are the
    CIDEr-D of the decoded rollouts and of the baseline decode, and the
    gradient is ``scst_loss``'s on those rollouts and advantages (a
    second, independent pass over the same tokens)."""
    _, _, pm = models(False)
    jt, pt = tokenizers()
    ids, segs, attn, f = (x[:1] for x in decode_inputs())
    _, pcfg = gen_configs(top_k=20)
    refs = {"img0": [["man", "man"], ["the", "dog"]]}
    scorer = run_captioning.CiderD(refs)
    batch = as_torch(segs, attn, f, ids)
    grads, r_s, r_b = scst.scst_step(
        pm, pcfg, scorer, pt, batch, ["img0"], torch.Generator().manual_seed(4),
        sample_n=3, baseline_type="greedy" if baseline == "beam" else baseline,
        baseline_beams=2 if baseline == "beam" else 1)
    sample_cfg = dataclasses.replace(pcfg, do_sample=True)
    ctx = tuple(torch.repeat_interleave(x, 3, 0) for x in batch)
    sampled, _ = gen.greedy_or_sample(pm, sample_cfg, *ctx[:3],
                                      torch.Generator().manual_seed(4),
                                      base_ids=ctx[3])
    rewards = np.asarray([scorer.score("img0", gen.decode_caption(pt, t, pcfg).split())
                          for t in sampled.numpy()])
    assert r_s == pytest.approx(float(rewards.mean()), abs=1e-6)
    if baseline == "sample":
        assert r_b == r_s
        base = None
    else:
        if baseline == "beam":
            bc = dataclasses.replace(pcfg, num_beams=2, num_keep_best=1)
            toks = gen.beam_search(pm, bc, *batch[:3], base_ids=batch[3])[0][:, 0]
        else:
            toks = gen.greedy_or_sample(pm, pcfg, *batch[:3], base_ids=batch[3])[0]
        base = np.asarray([scorer.score("img0", gen.decode_caption(
            pt, toks[0].numpy(), pcfg).split())])
        assert r_b == pytest.approx(float(base[0]), abs=1e-6)
    adv = scst.scst_advantages(rewards[None], base, baseline if baseline != "beam"
                               else "greedy")
    np.testing.assert_allclose(adv, jscst.scst_advantages(
        rewards[None], base, "sample" if baseline == "sample" else "greedy"))
    loss = scst.scst_loss(pm, pcfg, sampled, torch.from_numpy(adv.reshape(-1)),
                          ctx[:3], ctx[3])
    want = torch.autograd.grad(loss, list(pm.parameters()), allow_unused=True)
    assert len(grads) == len(want) and all(np.isfinite(g.numpy()).all()
                                           for g in grads if g is not None)
    for g, w in zip(grads, want):
        assert (g is None) == (w is None) and (g is None or torch.equal(g, w))


def test_scst_optimizer_is_optax_adam_after_the_clip():
    """The SCST optimizer (the port's ``Optimizer``: decay 0, a constant
    rate, betas (0.9, 0.999), eps 1e-8, the clip of ``--max_grad_norm``)
    against optax's ``chain(clip_by_global_norm, adam(lr))`` over 4 steps
    of random gradients (the clip active on two), and with
    ``--freeze_embedding`` the table unmoved."""
    _, _, pm = models(False)
    for freeze in (False, True):
        args = run_captioning.build_args().parse_args(
            ["--learning_rate", "2e-3", "--max_grad_norm", "5.0"]
            + (["--freeze_embedding"] if freeze else []))
        model = cap.BertForImageCaptioning(pm.config)
        model.load_state_dict(pm.state_dict())
        tx = run_captioning.scst_optimizer(model, args)
        params = list(model.parameters())
        names = [n for n, _ in model.named_parameters()]
        opt = tx.init(params)
        ref = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(2e-3))
        jp = {n: jnp.array(p.detach().numpy(), copy=True)
              for n, p in zip(names, params)}
        jopt = ref.init(jp)
        rng = np.random.RandomState(8)
        for it in range(4):
            scale = (0.5, 30.0, 0.01, 10.0)[it]
            g = [rng.randn(*p.shape).astype(np.float32) * scale / len(params)
                 for p in params]
            tx.update([torch.from_numpy(x) for x in g], opt, params)
            upd, jopt = ref.update({n: jnp.asarray(x) for n, x in zip(names, g)},
                                   jopt, jp)
            if freeze:
                upd["bert.embeddings.word_embeddings"] = jnp.zeros_like(
                    upd["bert.embeddings.word_embeddings"])
            jp = optax.apply_updates(jp, upd)
        for n, p in zip(names, params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                       atol=1e-6, rtol=1e-6, err_msg=n)
        emb = dict(zip(names, params))["bert.embeddings.word_embeddings"]
        assert torch.equal(emb, pm.bert.embeddings.word_embeddings) == freeze


def test_untied_decoder_converts_as_jax(capsys):
    """``utils/convert``: the caption task carries
    ``cls.predictions.decoder.weight`` when untied (the JAX converter's
    ``mlm_head/decoder``) and drops it when tied, with the JAX converter's
    warning where it differs from the embedding table; ``jax_paths`` /
    ``params_from_jax`` name the leaf; the CPT head still ties."""
    for tied in (False, True):
        jcfg, pcfg = configs(tied)
        sd = jconv.random_oscar_state_dict(jcfg, seed=3)
        tree = jconv.convert_bert_state_dict(sd, jcfg)
        jout = capsys.readouterr().out
        state = bconv.state_from_reference(sd, pcfg, "caption")
        out = capsys.readouterr().out
        assert ("WARNING" in out) == ("WARNING" in jout) == tied
        assert "differs from the embedding table" in out or not tied
        assert ("mlm_head.decoder" in state) == (not tied)
        assert ("mlm_head.decoder" in bconv.jax_paths(pcfg, "caption")) == (not tied)
        want = bconv.params_from_jax({"bert": tree["bert"],
                                      "mlm_head": tree["mlm_head"]}, pcfg, "caption")
        assert sorted(state) == sorted(want)
        for k in want:
            assert torch.equal(state[k], want[k]), k
        model = cap.BertForImageCaptioning(pcfg)
        model.load_state_dict(state)
        if not tied:
            np.testing.assert_array_equal(model.mlm_head.decoder.detach().numpy(),
                                          sd["cls.predictions.decoder.weight"])
        bconv.state_from_reference(sd, pcfg, "caption", warn=False)
        assert "WARNING" not in capsys.readouterr().out
    assert "mlm_head.decoder" not in bconv.jax_paths(configs(False)[1], "rec_mlm_cpt")
    assert BertLMPredictionHead(configs(False)[1], torch.float32).tied


def test_fresh_caption_head_draws_flax_defaults():
    """Without a checkpoint's head the caption model's MLM head starts as
    flax's: the transform's kernel lecun-normal, LayerNorm 1 / 0, the
    biases 0 and an untied decoder normal with std 0.02 (statistics over
    the draw), the encoder from the checkpoint."""
    _, pcfg = configs(False)
    pcfg = dataclasses.replace(pcfg, hidden_size=64, num_attention_heads=4)
    model = cap.BertForImageCaptioning(pcfg)
    sd = bconv.random_oscar_state_dict(pcfg, seed=1)
    model.init_heads(torch.Generator().manual_seed(0))
    bconv.load_bert_only(model, sd)
    head = model.mlm_head
    dec = head.decoder.detach()
    assert abs(float(dec.std()) - 0.02) < 2e-3 and abs(float(dec.mean())) < 2e-3
    k = head.transform.dense.kernel.detach()
    assert abs(float(k.std()) - (1 / 64) ** 0.5) < 0.02 and float(k.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.8796 + 1e-6
    assert float(head.bias.detach().abs().max()) == 0.0
    assert torch.equal(head.transform.LayerNorm.scale, torch.ones(64))
    np.testing.assert_array_equal(model.bert.embeddings.word_embeddings.detach().numpy(),
                                  sd["bert.embeddings.word_embeddings.weight"])
