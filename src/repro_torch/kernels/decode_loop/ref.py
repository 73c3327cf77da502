"""Plain PyTorch version of the decode-loop control kernel
(``csrc/decode_loop.cu``): the JAX engine's loop body epilogue and cond
(``repro.serving.engine._decode_many``) over the packed int32 buffers
that :mod:`.decode_loop` lays out.  Tensor operations only, so it runs on
CUDA tensors as well (the card tests hold the kernel to it there) and
never reads a value back to the host."""

from __future__ import annotations

import torch

I32 = torch.int32


def views(inp: torch.Tensor, out: torch.Tensor, B: int, k: int):
    """(tokens, active, eos, remaining, limit, stop_on_free) of ``inp`` and
    (n, toks, acts, dones) of ``out``, as views."""
    tokens, active, eos, remaining = inp[:4 * B].view(4, B)
    n = out[:1]
    toks, acts, dones = out[1:].view(3, k, B)
    return (tokens, active, eos, remaining, inp[4 * B:4 * B + 1],
            inp[4 * B + 1:4 * B + 2]), (n, toks, acts, dones)


def init_plain(inp: torch.Tensor, out: torch.Tensor, ctl: torch.Tensor, *,
               B: int, k: int) -> None:
    """The chunk's start: n and the rows zeroed, freed cleared,
    go = limit > 0 & any(active)."""
    (_, active, _, _, limit, _), _ = views(inp, out, B, k)
    out.zero_()
    ctl[:1].zero_()
    ctl[1:].copy_((limit > 0) & (active != 0).any())


def epilogue_plain(sampled: torch.Tensor, lengths: torch.Tensor,
                   inp: torch.Tensor, out: torch.Tensor, ctl: torch.Tensor,
                   *, k: int, max_len: int) -> None:
    """One tick's control, in place: the token writeback, the done-mask
    (EOS / cache-full / budget), row ``n`` of toks/acts/dones, then
    n += 1 and the next tick's predicate in ``ctl[1]``."""
    B = sampled.shape[0]
    (tokens, active, eos, remaining, limit, stop), (n, toks, acts, dones) = \
        views(inp, out, B, k)
    s = sampled.to(I32)
    act = active != 0
    tok = torch.where(act, s, tokens)
    rem = remaining - act.to(I32)
    hit = (eos >= 0) & (s == eos)
    done = act & (hit | (lengths >= max_len - 1) | (rem <= 0))
    still = act & ~done
    row = n.long().clamp(max=k - 1)
    inside = n < k                       # always, while the loop runs
    for buf, val in ((toks, tok), (acts, act.to(I32)), (dones, done.to(I32))):
        buf.index_copy_(0, row, torch.where(inside, val,
                                            buf.index_select(0, row)[0])[None])
    tokens.copy_(tok)
    remaining.copy_(rem)
    active.copy_(still.to(I32))
    freed = (ctl[:1] != 0) | done.any()
    ctl[:1].copy_(freed)
    n.add_(1)
    ctl[1:].copy_((n < limit) & still.any() & ~((stop != 0) & freed))
