"""Replay of a JAX ServeEngine's model outputs into a port ServeEngine
(`from _torch_replay import Replay`; not a test module).

`Replay().record(jax_engine)` wraps the JAX engine's jitted model calls
(prefill, suffix prefill, decode, draft prefill, draft decode, verify)
and keeps, per call, the tokens, the per-row positions before the call
and the logits. `replay(port_engine)` then replaces the port engine's
Model entry points with stand-ins that assert each call's tokens and
positions equal the JAX call's of the same kind and index, answer it with
the JAX call's logits and advance "pos" as the real entry point would
(the k/v lines are left alone). Scheduling, sampling, the spec accept
loop, rollback and page accounting then run on identical inputs in both
packages, so the port must emit the JAX engine's tokens exactly, at any
temperature; the models' own numerics are held elsewhere, within their
bf16 tolerances.
"""

import numpy as np
import torch


class Replay:
    """Records every model call of a JAX engine (tokens, per-row pos
    before the call, logits), then answers the port engine's calls with
    them, asserting each call's tokens and positions are the JAX call's."""

    KINDS = {"_prefill_slot": "prefill", "_prefill_cont": "prefill_cont",
             "_decode": "decode", "_draft_prefill": "draft_prefill",
             "_draft_decode": "draft_decode", "_verify": "verify"}

    def __init__(self):
        self.calls = {kind: [] for kind in self.KINDS.values()}
        self.used = {kind: 0 for kind in self.KINDS.values()}

    def record(self, jeng):
        for attr, kind in self.KINDS.items():
            if getattr(jeng, attr, None) is not None:
                setattr(jeng, attr, self._recorder(getattr(jeng, attr), kind))

    def _recorder(self, inner, kind):
        def call(p, c, *args):
            logits, new = inner(p, c, *args)
            toks = args[1]["tokens"] if "prefill" in kind else args[0]
            # copies: a numpy view of a JAX CPU buffer does not keep the
            # buffer alive once the Array is collected
            self.calls[kind].append((np.array(toks), np.array(c["pos"]),
                                     np.array(logits, np.float32)))
            return logits, new
        return call

    def replay(self, teng):
        m, d = teng.model, teng.draft_model
        m.prefill_into_slot = self._prefill("prefill")
        m.decode_step = self._step("decode", 1)
        m.decode_verify = self._step("verify", None)
        m.prefill_continue = self._continue("prefill_cont")
        if d is not None:
            d.prefill_into_slot = self._prefill("draft_prefill")
            d.decode_step = self._step("draft_decode", 1)

    def _next(self, kind, toks, pos):
        i = self.used[kind]
        self.used[kind] += 1
        want_toks, want_pos, logits = self.calls[kind][i]
        np.testing.assert_array_equal(toks.numpy(), want_toks,
                                      err_msg=f"{kind} call {i}: tokens")
        np.testing.assert_array_equal(pos.numpy(), want_pos,
                                      err_msg=f"{kind} call {i}: pos")
        return torch.from_numpy(logits.copy())

    def _prefill(self, kind):
        def prefill_into_slot(params, cache, slot, batch, prompt_len):
            logits = self._next(kind, batch["tokens"], cache["pos"])
            pos = cache["pos"].clone()
            pos[slot] = prompt_len
            return logits, {**cache, "pos": pos}
        return prefill_into_slot

    def _continue(self, kind):
        def prefill_continue(params, cache, slot, batch, start, n_real):
            logits = self._next(kind, batch["tokens"], cache["pos"])
            pos = cache["pos"].clone()
            pos[slot] = start + n_real
            return logits, {**cache, "pos": pos}
        return prefill_continue

    def _step(self, kind, width):
        def step(params, cache, tokens):
            logits = self._next(kind, tokens, cache["pos"])
            return logits, {**cache, "pos": cache["pos"]
                            + (width or tokens.shape[1])}
        return step

    def check_all_used(self):
        assert self.used == {k: len(v) for k, v in self.calls.items()}


def record_sampled_logits(monkeypatch, eng, store):
    """Wrap eng._sample_rows (a JAX or a port engine) to keep each live
    row's f32 logits by (rid, n_gen), the token index it is about to
    sample."""
    inner = eng._sample_rows

    def wrapped(logits, slots):
        lg = np.asarray(logits.float() if isinstance(logits, torch.Tensor)
                        else logits, np.float32).reshape(len(slots), -1)
        for i, s in enumerate(slots):
            if s is not None:
                store[(s.rid, s.n_gen)] = lg[i]
        return inner(logits, slots)

    monkeypatch.setattr(eng, "_sample_rows", wrapped)


def greedy_up_to_near_ties(jlog, tlog, jout, tout, tol):
    """Hold a port engine's greedy run to a JAX engine's on the same
    requests: along each request, the logits at every token within `tol`
    of JAX's and the token equal, up to the first token whose JAX top-2
    margin is within `tol` (a near tie: the two argmaxes may differ there
    and the continuations after it condition on different tokens).
    Returns how many tokens were compared."""
    assert set(tout) == set(jout)
    compared = 0
    for rid, want in jout.items():
        assert len(tout[rid]) == len(want), rid
        for n, tok in enumerate(want):
            lj, lt = jlog[(rid, n)], tlog[(rid, n)]
            np.testing.assert_allclose(lt, lj, atol=tol, rtol=0,
                                       err_msg=f"rid {rid} token {n}")
            top2 = np.sort(lj)[-2:]
            if top2[1] - top2[0] <= tol:
                break
            assert tout[rid][n] == tok, (rid, n)
            compared += 1
    return compared
