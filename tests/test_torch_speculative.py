"""Speculative decoding in the port: ``speculative_verify`` against the JAX
package's, and ``generate.speculate`` against the speculative loop of the
JAX package's ``examples/llm_decode.py`` (lines 117-158), on the CPU.

* Greedy ``speculative_verify``: bit-equal to the JAX function on the same
  logits (ties included: both take the first maximum).
* Sampling mode: p = q accepts every draft; a target with no mass on the
  drafts rejects at 0 and resamples where p > q; a chi-square test (p-value
  >= 1e-3, a fixed generator) that the first token out follows the target
  distribution, the property the rejection rule exists for.
* The loop on the tiny flax ``CausalLM`` of ``tests/test_torch_llm.py``,
  fp32, exact-attention prefill, dense int8 and paged int8 caches: the same
  tokens and ``n_accepted`` each round as a JAX rendition of the example's
  loop built here from the flax model's decode (which does not pass
  ``core._entry``); the same tokens as the port's plain greedy
  ``generate``, also when the verifier is made to keep shorter prefixes
  (the rollback by lengths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sageattention_tpu import models as jmodels
from sageattention_tpu.models.configs import MODEL_CONFIGS as J_CONFIGS
from sageattention_tpu.speculative import speculative_verify as j_verify
from sageattention_tpu_torch import generate, models, speculative, speculative_verify
from sageattention_tpu_torch.models.convert import llm_params_from_jax

PROMPT, GEN, K, PAGE = 16, 12, 3, 16
MAX_LEN = PROMPT + GEN + K


@pytest.mark.parametrize("k", [1, 4])
def test_greedy_verify_bit_equal_to_jax(k):
    rng = np.random.default_rng(k)
    b, vocab = 64, 40
    logits = rng.standard_normal((b, k + 1, vocab)).astype(np.float32)
    logits[:8, :, 3] = logits[:8].max(axis=-1) + 0.0  # exact ties at the maximum
    logits[:8, :, 7] = logits[:8, :, 3]
    tgt = logits[:, :k].argmax(-1)
    # drafts that follow the target for a random prefix, then differ
    cut = rng.integers(0, k + 1, b)
    drafts = np.where(np.arange(k)[None] < cut[:, None], tgt, (tgt + 1) % vocab).astype(np.int32)
    n_t, nxt_t = speculative_verify(torch.from_numpy(drafts), torch.from_numpy(logits))
    n_j, nxt_j = j_verify(jnp.asarray(drafts), jnp.asarray(logits))
    assert n_t.dtype == nxt_t.dtype == torch.int32
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j))
    np.testing.assert_array_equal(n_t.numpy(), cut)


def test_sampling_p_equals_q_accepts_everything():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(32, 5, 20, generator=g)
    drafts = torch.randint(0, 20, (32, 4), generator=g)
    n_acc, nxt = speculative_verify(drafts, logits, logits[:, :4], g, greedy=False)
    assert (n_acc == 4).all() and ((nxt >= 0) & (nxt < 20)).all()


def test_sampling_disjoint_target_rejects_at_zero():
    g = torch.Generator().manual_seed(1)
    drafts = torch.randint(0, 10, (32, 3), generator=g)
    draft_logits = torch.randn(32, 3, 10, generator=g)
    target = torch.randn(32, 4, 10, generator=g)
    target[:, :3].scatter_(-1, drafts[..., None], -1e9)  # no target mass on a draft
    n_acc, nxt = speculative_verify(drafts, target, draft_logits, g, greedy=False)
    assert (n_acc == 0).all()
    p = torch.softmax(target[:, 0], -1)
    q = torch.softmax(draft_logits[:, 0], -1)
    picked = nxt.long()[:, None]
    assert (picked[:, 0] != drafts[:, 0]).all()
    assert ((p.gather(1, picked) - q.gather(1, picked)) > 0).all()
    with pytest.raises(ValueError, match="draft_logits and a generator"):
        speculative_verify(drafts, target, greedy=False)


def test_sampled_first_token_follows_the_target():
    """Drafts drawn from q, verified against p: the first token out (the
    draft if accepted, else the resample) is distributed as p."""
    g = torch.Generator().manual_seed(2)
    n, vocab, k = 200_000, 6, 3
    p_logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 0.3])
    q_logits = torch.tensor([0.0, 1.5, 0.5, 1.0, 0.2, -0.5])
    target = p_logits.expand(n, k + 1, vocab)
    draft = q_logits.expand(n, k, vocab)
    drafts = torch.multinomial(torch.softmax(q_logits, 0), n * k, replacement=True,
                               generator=g).reshape(n, k)
    n_acc, nxt = speculative_verify(drafts, target, draft, g, greedy=False)
    first = torch.where(n_acc > 0, drafts[:, 0], nxt.long())
    counts = torch.bincount(first, minlength=vocab).numpy()
    expected = torch.softmax(p_logits, 0).double().numpy() * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert stats.chi2.sf(chi2, vocab - 1) >= 1e-3, (chi2, counts, expected)
    # the drafts alone (q) would fail the same test
    q_counts = torch.bincount(drafts[:, 0], minlength=vocab).numpy()
    assert stats.chi2.sf(float(((q_counts - expected) ** 2 / expected).sum()), vocab - 1) < 1e-6


def _tiny(cfgs):
    return cfgs["llm-8b-gqa"].scaled(depth=2, hidden=128, heads=4, kv_heads=2, head_dim=32,
                                     vocab=128, mlp_hidden=256)


@pytest.fixture(scope="module")
def pair():
    prev_j, prev_t = jmodels.get_attention_backend(), models.get_attention_backend()
    jmodels.set_attention_backend("reference")
    models.set_attention_backend("reference")
    jm = jmodels.CausalLM(_tiny(J_CONFIGS), dtype=jnp.float32)
    toks = np.random.default_rng(0).integers(0, 128, (1, PROMPT)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(1), jnp.array(toks[:, :8]))
    sd = llm_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    tm = generate.load_llm(_tiny(models.MODEL_CONFIGS), device="cpu", state_dict=sd,
                           dtype=torch.float32)
    yield jm, params, tm, toks
    jmodels.set_attention_backend(prev_j)
    models.set_attention_backend(prev_t)


def _table():
    return np.random.default_rng(2).permutation(-(-MAX_LEN // PAGE)).reshape(1, -1)


def _jax_speculate(jm, params, toks, cache):
    """``examples/llm_decode.py:117-158`` without its timing: drafts on a
    copy of the (immutable) caches, one extend step to verify."""
    if cache == "paged":
        caches = jm.init_paged_caches(1, MAX_LEN, page_size=PAGE,
                                      page_table=jnp.array(_table()), bits=8)
    else:
        caches = jm.init_caches(1, MAX_LEN, bits=8)
    lengths = jnp.zeros((1,), jnp.int32)
    logits, caches = jm.apply(params, jnp.array(toks), caches=caches, lengths=lengths)
    lengths = lengths + toks.shape[1]
    cur = jnp.argmax(logits[:, -1:], axis=-1)
    out, rounds = [cur], []
    while len(out) - 1 < GEN:
        dcaches, dlen, dcur, drafts = caches, lengths, cur, []
        for _ in range(K):
            dl, dcaches = jm.apply(params, dcur, caches=dcaches, lengths=dlen, decode=True)
            dlen = dlen + 1
            dcur = jnp.argmax(dl[:, -1:], axis=-1)
            drafts.append(dcur)
        block = jnp.concatenate([cur] + drafts, axis=1)
        logits, caches = jm.apply(params, block, caches=caches, lengths=lengths, decode=True)
        n_acc, nxt = j_verify(jnp.concatenate(drafts, axis=1), logits)
        na = int(n_acc[0])
        out.extend(drafts[:na] + [nxt[:, None]])
        rounds.append(na)
        lengths = lengths + 1 + na
        cur = nxt[:, None]
    return np.asarray(jnp.concatenate(out, axis=1))[:, :GEN + 1], rounds


def _port_kw(cache):
    if cache == "paged":
        return dict(cache="paged", page_size=PAGE,
                    page_table=torch.tensor(_table(), dtype=torch.int32))
    return dict(cache="dense")


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_loop_matches_the_jax_loop(pair, cache):
    jm, params, tm, toks = pair
    want, rounds = _jax_speculate(jm, params, toks, cache)
    got = generate.speculate(tm, torch.from_numpy(toks).long(), GEN, k=K, max_len=MAX_LEN,
                             **_port_kw(cache))
    np.testing.assert_array_equal(got["tokens"].numpy(), want)
    assert got["n_accepted"] == rounds
    assert got["drafted"] == K * len(rounds) and got["accepted"] == sum(rounds)
    assert len(got["draft_ms"]) == len(got["verify_ms"]) == len(rounds)
    assert got["tokens_per_s"] > 0 and got["device"] == "cpu"


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_loop_gives_plain_greedy_tokens(pair, cache, monkeypatch):
    """The same tokens as ``generate``, as the model accepts them and when
    the verifier keeps shorter prefixes: each round's first n drafts (n
    cycling 0..K) and the target's token after them, which greedy decoding
    would give; the rejected rows roll back by the lengths."""
    _, _, tm, toks = pair
    prompt = torch.from_numpy(toks).long()
    plain = generate.generate(tm, prompt, GEN, max_len=MAX_LEN, **_port_kw(cache))["tokens"]
    got = generate.speculate(tm, prompt, GEN, k=K, max_len=MAX_LEN, **_port_kw(cache))
    assert torch.equal(got["tokens"], plain)
    rounds = []

    def shorter(drafts, logits):
        n = min(len(rounds) % (K + 1), speculative.speculative_verify(drafts, logits)[0].item())
        rounds.append(n)
        return (torch.tensor([n], dtype=torch.int32),
                logits[:, n].argmax(dim=-1).int())

    monkeypatch.setattr(generate, "speculative_verify", shorter)
    got = generate.speculate(tm, prompt, GEN, k=K, max_len=MAX_LEN, **_port_kw(cache))
    assert got["n_accepted"] == rounds and min(rounds) == 0 and len(rounds) > GEN // (K + 1)
    assert torch.equal(got["tokens"], plain)


def test_loop_refuses_what_it_cannot_do(pair):
    _, _, tm, toks = pair
    prompt = torch.from_numpy(toks).long()
    with pytest.raises(ValueError, match="b must be 1"):
        generate.speculate(tm, prompt.expand(2, -1), GEN, k=K)
    with pytest.raises(ValueError, match="no room"):
        generate.speculate(tm, prompt, GEN, k=K, max_len=PROMPT + GEN)
