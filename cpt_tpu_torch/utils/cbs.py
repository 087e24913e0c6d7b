"""Constrained beam search (CBS): finite-state-machine decoding (port of
``cpt_tpu/utils/cbs.py``).

As the reference ``Oscar/oscar/utils/cbs.py`` (Anderson et al.'s
constrained beam search, behind ``CaptionTSVDatasetWithConstraints``) does
it: decoding keeps one beam set per FSM state; the FSM tracks which
constraint words or phrases have been emitted; the caption is the best
beam among the states that satisfy at least ``min_constraints_to_satisfy``.

The FSM is a dense ``[num_states, vocab]`` int32 transition table built on
the host from the constraints (``build_fsm``, numpy: the JAX module's
code, which ``tests/test_torch_isolation.py`` holds to it); the search
runs ``max_len − 1`` fixed-shape steps on the device, each a per-state
masked top-k. The top-k is a stable descending sort, so among the many
``NEG`` ties the lower index wins, as under ``jax.lax.top_k``
(``cpt_tpu/utils/cbs.py:135``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from cpt_tpu_torch.models.bert.captioning import top_k_stable

NEG = -1e9


def build_fsm(constraints: Sequence[Sequence[int]], vocab_size: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """constraints: list of token-id sequences (single- or multi-token).

    Returns (transitions [S, V] int32, num_satisfied [S] int32). Group
    states are the 2^C satisfaction subsets; multi-token constraints add
    chain states from each group state where they are still unsatisfied.
    """
    c = len(constraints)
    n_groups = 1 << c
    states: List[Tuple] = [("g", m) for m in range(n_groups)]
    chain_index = {}
    for ci, toks in enumerate(constraints):
        if len(toks) <= 1:
            continue
        for m in range(n_groups):
            if m & (1 << ci):
                continue
            for depth in range(1, len(toks)):
                chain_index[(ci, m, depth)] = len(states)
                states.append(("c", ci, m, depth))

    s = len(states)
    trans = np.zeros((s, vocab_size), np.int32)
    n_sat = np.zeros((s,), np.int32)

    def group_state(mask):
        return mask  # group states are the first n_groups entries

    for si, st in enumerate(states):
        if st[0] == "g":
            mask = st[1]
            n_sat[si] = bin(mask).count("1")
            trans[si, :] = si  # default: stay
            for ci, toks in enumerate(constraints):
                if mask & (1 << ci) or not toks:
                    continue
                first = toks[0]
                if len(toks) == 1:
                    trans[si, first] = group_state(mask | (1 << ci))
                else:
                    trans[si, first] = chain_index[(ci, mask, 1)]
        else:
            _, ci, mask, depth = st
            n_sat[si] = bin(mask).count("1")
            toks = constraints[ci]
            # default: fall back to the group state (chain broken)
            trans[si, :] = group_state(mask)
            # but other constraints can still start from the group context
            for cj, toks_j in enumerate(constraints):
                if mask & (1 << cj) or not toks_j or cj == ci:
                    continue
                if len(toks_j) == 1:
                    trans[si, toks_j[0]] = group_state(mask | (1 << cj))
                else:
                    trans[si, toks_j[0]] = chain_index[(cj, mask, 1)]
            nxt = toks[depth]
            if depth + 1 == len(toks):
                trans[si, nxt] = group_state(mask | (1 << ci))
            else:
                trans[si, nxt] = chain_index[(ci, mask, depth + 1)]
    return trans, n_sat


@torch.no_grad()
def constrained_beam_search(step_logits_fn, context, *,
                            transitions: np.ndarray, num_satisfied: np.ndarray,
                            beams_per_state: int, max_len: int,
                            bos_id: int, eos_id: int, pad_id: int,
                            min_constraints: int,
                            length_penalty: float = 1.0,
                            num_group_states: int = 0, device=None):
    """Single-image CBS.

    step_logits_fn(tokens [N, L], step, *context) → [N, V] on ``device``.
    Returns (tokens [La], score) of the best beam among the states with
    ``num_satisfied ≥ min_constraints`` (falling back to the global best).
    ``num_group_states`` > 0 restricts the choice to the group
    (satisfaction-subset) states, leaving out the mid-phrase chain states,
    as the reference's ``select_best_beam_with_constraints`` considers only
    ``range(2**num_constraints)`` (``cbs.py:414-419``).
    """
    s = transitions.shape[0]
    k = beams_per_state
    n = s * k
    trans = torch.as_tensor(transitions, dtype=torch.long, device=device)
    nsat = torch.as_tensor(num_satisfied, dtype=torch.long, device=device)

    tokens = torch.full((n, max_len), pad_id, dtype=torch.long, device=device)
    tokens[:, 0] = bos_id
    # beam 0 of state 0 is live; everything else NEG
    scores = torch.full((n,), NEG, dtype=torch.float32, device=device)
    scores[0] = 0.0
    states = torch.arange(s, device=device)
    state_of = torch.repeat_interleave(states, k)
    finished = torch.zeros(n, dtype=torch.bool, device=device)

    for step in range(1, max_len):
        logits = step_logits_fn(tokens, step, *context)
        logp = torch.log_softmax(logits.float(), -1)
        vocab = logp.shape[-1]
        pad_only = torch.full((vocab,), NEG, dtype=torch.float32, device=device)
        pad_only[pad_id] = 0.0
        logp = torch.where(finished[:, None], pad_only[None], logp)
        cand = scores[:, None] + logp                        # [N, V]
        # candidate (i, v) lands in state T[state_of[i], v]; finished beams
        # keep their state
        cand_state = torch.where(finished[:, None], state_of[:, None],
                                 trans[state_of])            # [N, V]
        flat = cand.reshape(-1)
        flat_state = cand_state.reshape(-1)
        # each state's own top-k over the candidates landing in it
        masked = torch.where(flat_state[None] == states[:, None], flat[None], NEG)
        sc, idx = top_k_stable(masked, k)                    # [S, K]
        sc, idx = sc.reshape(-1), idx.reshape(-1)            # [N]
        src = idx // vocab
        tok = idx % vocab
        tokens = tokens[src]
        new_finished = finished[src]
        tok = torch.where(new_finished, pad_id, tok)
        tokens[:, step] = tok
        finished = new_finished | (tok == eos_id)
        scores = sc
        state_of = torch.repeat_interleave(states, k)

    # reference normalization (cbs.py::select_best_beam_with_constraints):
    # score / (count of non-EOS generated tokens + 1), BOS and the EOS
    # itself left out of the count
    has_eos = torch.any(tokens == eos_id, dim=1)
    n_real = (torch.sum(tokens != pad_id, dim=1) - 1 - has_eos.long()).float()
    norm = scores / ((n_real + 1.0) ** length_penalty)
    ok = nsat[state_of] >= min_constraints
    if num_group_states > 0:
        ok = ok & (state_of < num_group_states)
    # the reference considers only beam 0 of each state
    # (cbs.py::select_best_beam_with_constraints indexes
    # beams[i, valid_states, 0, :]); per-state beams are sorted by raw
    # cumulative score, so beam 0 is slot s*k
    is_beam0 = (torch.arange(n, device=device) % k) == 0
    ok = ok & is_beam0
    sat_norm = torch.where(ok, norm, NEG)
    best_sat = torch.argmax(sat_norm)
    best_any = torch.argmax(torch.where(is_beam0, norm, NEG))
    use_sat = sat_norm[best_sat] > NEG / 2
    best = torch.where(use_sat, best_sat, best_any)
    return tokens[best], norm[best]
