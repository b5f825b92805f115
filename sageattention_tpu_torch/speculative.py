"""Speculative decoding: verifying a block of draft tokens against the
target model's logits, the counterpart of the JAX package's
``speculative.py``.

The attention side is the decode kernels' ``t_q > 1`` causal tail: one
extend step scores the whole draft block against the quantized cache, and
a rejected tail rolls back by the lengths alone (per-token scales leave no
state in stale rows; the next append overwrites them).

The acceptance rule (Leviathan et al., arXiv 2211.17192): accept draft
token i while u_i < min(1, p_target / p_draft), and resample the first
rejected position from norm(max(p - q, 0)), so that the tokens follow the
target model's distribution exactly.  Greedy serving (temperature 0)
accepts while the target's argmax equals the draft token.
"""

from __future__ import annotations

import torch


def _first_false(ok: torch.Tensor) -> torch.Tensor:
    """[b] int32: the index of the first False in each row of ``ok`` [b, k],
    k where there is none."""
    pad = torch.zeros_like(ok[:, :1])
    return torch.cat([ok, pad], dim=1).int().argmin(dim=1).int()


@torch.inference_mode()
def speculative_verify(draft_tokens: torch.Tensor, target_logits: torch.Tensor,
                       draft_logits: torch.Tensor | None = None,
                       generator: torch.Generator | None = None, *, greedy: bool = True):
    """Verify draft tokens [b, k] against ``target_logits`` [b, k + 1, V]:
    row i is the target's distribution at draft position i (after the
    tokens before it), row k the bonus token's when every draft is
    accepted; the logits of one ``t_q = k + 1`` extend step.

    Returns ``(n_accepted [b] int32, next_token [b] int32)``: the draft
    prefix to keep and the corrected or bonus token after it.  The caller
    appends ``next_token`` and sets ``lengths = base + 1 + n_accepted``.

    ``greedy=False`` takes ``draft_logits`` [b, k, V] (the draft's
    distributions the tokens were drawn from) and draws its uniforms and
    the resampled token from ``generator``."""
    b, k = draft_tokens.shape
    draft_tokens = draft_tokens.long()
    if greedy:
        tgt = target_logits[:, :k].argmax(dim=-1)
        n_acc = _first_false(tgt == draft_tokens)
        all_tok = torch.cat([tgt, target_logits[:, k].argmax(dim=-1)[:, None]], dim=1)
        next_token = all_tok.gather(1, n_acc[:, None].long())[:, 0]
        return n_acc, next_token.int()

    if draft_logits is None or generator is None:
        raise ValueError("sampling mode needs draft_logits and a generator")
    p = torch.softmax(target_logits[:, :k].float(), dim=-1)
    q = torch.softmax(draft_logits.float(), dim=-1)
    p_tok = p.gather(-1, draft_tokens[..., None])[..., 0]
    q_tok = q.gather(-1, draft_tokens[..., None])[..., 0]
    u = torch.rand((b, k), generator=generator, device=p.device)
    n_acc = _first_false(u * q_tok < p_tok)  # u < p / q without the divide
    # the residual at the first rejected position; the bonus row appended
    # so that n_acc == k draws from the plain target
    resid = (p - q).clamp_min(0.0)
    resid = resid / resid.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    bonus = torch.softmax(target_logits[:, k:].float(), dim=-1)
    dist = torch.cat([resid, bonus], dim=1)
    at_n = dist[torch.arange(b, device=dist.device), n_acc.long()]
    next_token = torch.multinomial(at_n.clamp_min(1e-20), 1, generator=generator)[:, 0]
    return n_acc, next_token.int()
