"""Propose/verify/accept core for speculative decoding — the port of
`repro.serve.spec` (the whole module).

The slot scheduler (serve/engine.py) pairs the target model with a small
draft model. Each spec round, per active slot:

  propose  the draft runs spec_k sequential decode steps from the last
           committed token, sampling candidates d_0..d_{k-1} from its own
           distribution (greedy rows take the draft argmax);
  verify   ONE (k+1)-position target forward (Model.decode_verify) over
           [cur, d_0..d_{k-1}] yields the target distribution after every
           candidate — logits[j] judges d_j, logits[k] is the bonus
           distribution past a full accept;
  accept   host-side (this module). Greedy (temperature 0): accept the
           longest prefix where d_j == argmax(logits[j]); the first
           mismatch emits the target argmax as a CORRECTION token, a full
           accept emits a BONUS token from logits[k]. Either way the round
           emits the exact prefix plain greedy decoding would have
           produced. Temperature > 0: rejection sampling — accept d_j with
           prob min(1, p_t/p_d), resample rejections from
           norm(max(p_t - p_d, 0)) — so the output distribution equals
           plain sampling (not the bitstream: the draws use salted keys).

Key schedule: every spec draw derives from the engine's per-request base,
fold_in(fold_in(base_key, rid), token_index), then a salt fold, so
draft/accept/residual/bonus draws never collide with each other or with
the plain path's un-salted stream. The draws are `serve/rng.py`'s
Threefry, the same bits as the JAX package's on the device of base_key;
the softmaxes are float64 numpy, and the residual and bonus logits are
rounded to float32 before the draw, where the reference's `jnp.asarray`
rounds them (64-bit types off).

Accounting: every emitted token is tagged "accepted" (a surviving draft
token), "rejected" (the correction at the first rejection) or "bonus"
(the extra token after a full accept), so accepted + rejected + bonus ==
tokens_emitted, per round and summed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve import rng

SALT_DRAFT = 101      # draft proposal draws (the engine's _spec_sample)
SALT_ACCEPT = 102     # accept/reject uniforms
SALT_RESIDUAL = 103   # residual-distribution resamples
SALT_BONUS = 104      # bonus draw after a full accept


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def spec_sample_key(base_key: torch.Tensor, rid: int, index: int,
                    salt: int) -> torch.Tensor:
    """The salted per-request key for spec draw `index` of request `rid`
    — fold_in(fold_in(fold_in(base, rid), index), salt). index is the
    emitted-token index the draw belongs to (n_gen + j), so a re-queued
    request replays the identical draw sequence on any replica."""
    return rng.fold_in(rng.fold_in(rng.fold_in(base_key, rid), index), salt)


def _categorical_f32(key: torch.Tensor, logits64: np.ndarray) -> int:
    lg = torch.from_numpy(logits64.astype(np.float32)).to(key.device)
    return int(rng.categorical(key, lg))


def accept_greedy(draft_toks: Sequence[int], target_argmax: Sequence[int]
                  ) -> Tuple[List[int], List[str]]:
    """The temperature-0 accept decision from the target argmax at each of
    the k+1 verify positions: the longest agreeing prefix, then the
    correction (first mismatch) or the bonus (full accept)."""
    emitted: List[int] = []
    kinds: List[str] = []
    for j in range(len(draft_toks)):
        if int(draft_toks[j]) == int(target_argmax[j]):
            emitted.append(int(draft_toks[j]))
            kinds.append("accepted")
            continue
        emitted.append(int(target_argmax[j]))
        kinds.append("rejected")
        return emitted, kinds
    emitted.append(int(target_argmax[len(draft_toks)]))
    kinds.append("bonus")
    return emitted, kinds


def accept_tokens(draft_toks: np.ndarray, draft_logits: np.ndarray,
                  target_logits: np.ndarray, *, temperature: float,
                  base_key: torch.Tensor, rid: int, n_gen: int
                  ) -> Tuple[List[int], List[str]]:
    """The accept decision for one slot's spec round.

    draft_toks: (k,) candidate tokens; draft_logits: (k, V) the draft
    distribution each candidate was drawn from; target_logits: (k+1, V)
    the verify logits (position j judges d_j, position k is the bonus
    distribution). n_gen: tokens the request has emitted so far — the key
    schedule's base index for this round's draws. base_key: the engine's
    `rng.prng_key`; the draws run on its device.

    Returns (emitted, kinds): 1..k+1 tokens with a parallel provenance tag
    per token ("accepted" | "rejected" | "bonus")."""
    k = len(draft_toks)
    if temperature <= 0.0:
        return accept_greedy(draft_toks, np.argmax(target_logits, axis=-1))
    emitted: List[int] = []
    kinds: List[str] = []
    pt = _softmax(target_logits.astype(np.float64) / temperature)
    pd = _softmax(draft_logits.astype(np.float64) / temperature)
    for j in range(k):
        x = int(draft_toks[j])
        u = float(rng.uniform(spec_sample_key(base_key, rid, n_gen + j,
                                              SALT_ACCEPT)))
        if u < pt[j, x] / max(pd[j, x], 1e-30):
            emitted.append(x)
            kinds.append("accepted")
            continue
        resid = np.maximum(pt[j] - pd[j], 0.0)
        tot = float(resid.sum())
        # tot == 0 only when p_t == p_d exactly, where the accept ratio
        # was 1.0 and this branch is unreachable; guard numerically anyway
        probs = resid / tot if tot > 0.0 else pt[j]
        tok = _categorical_f32(
            spec_sample_key(base_key, rid, n_gen + j, SALT_RESIDUAL),
            np.log(probs + 1e-300))
        emitted.append(tok)
        kinds.append("rejected")
        return emitted, kinds
    tok = _categorical_f32(spec_sample_key(base_key, rid, n_gen + k,
                                           SALT_BONUS),
                           np.log(pt[k] + 1e-300))
    emitted.append(tok)
    kinds.append("bonus")
    return emitted, kinds
