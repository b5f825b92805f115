"""The slice as a whole: the port's CausalLM and its decode loop against the
JAX package's flax CausalLM, on the CPU, with the same weights.

A tiny ``llm-8b-gqa`` (depth 2, hidden 128, 4 query heads and 2 kv heads
of 32, vocab 128) is initialised in flax, carried across with
``llm_params_from_jax``, and both run a prompt and 3 teacher-forced decode
steps over the dense int8, the paged int8 (a scrambled table of 16-token
pages) and the dense int4 cache; the windowed model prefills in extend
blocks through the decode kernels, or in one shot through the windowed
attention (the masked forward).  The JAX prefill attention is the
``"reference"`` backend, or a test-side backend on
``core._sageattn_hnd(impl="xla", chunk_k=128)`` (``core._entry`` raises at
this revision) against the port's ``"sage"``; the JAX decode runs the
Pallas kernels in interpret mode, the port their plain versions.

Tolerances, on the logits of every prefill block and decode step: in fp32
(both models built with an fp32 compute dtype) cosine >= 0.99999 and
max-abs <= 5e-3 of the largest logit (measured about 1e-6 with the
"reference" prefill, and 1e-3 with the quantized prefill, where an fp32
rounding now and then moves one K or P code by a step); in bf16, the
models' own dtype, cosine >= 0.999 and max-abs <= 1e-1 (measured down to
0.9993 and 5.0e-2 with int4: the frameworks round bf16 activations at
different places, which moves codes by a step far more often).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import models as jmodels
from sageattention_tpu.models.attention import register_backend as j_register
from sageattention_tpu.models.configs import MODEL_CONFIGS as J_CONFIGS
from sageattention_tpu_torch import generate, models
from sageattention_tpu_torch.models.convert import llm_params_from_jax
from sageattention_tpu_torch.utils.compare import cosine_similarity

PROMPT, STEPS, PAGE, MAX_LEN = 16, 3, 16, 64


def _xla_sage(q, k, v, *, is_causal, sm_scale, window=None):
    return jcore._sageattn_hnd(
        q, k, v, None, None, None, None, None, None,
        impl="xla", chunk_k=128, qk_quant_gran="auto", pv_dtype="bf16",
        smooth_k=True, smooth_v=False, return_lse=False, is_causal=is_causal,
        sm_scale=sm_scale, block_q=128, block_k=128, window=window,
    )


def _tiny(cfgs, **kw):
    return cfgs["llm-8b-gqa"].scaled(depth=2, hidden=128, heads=4, kv_heads=2, head_dim=32,
                                     vocab=128, mlp_hidden=256, **kw)


@pytest.fixture(scope="module", autouse=True)
def jax_backend():
    j_register("torch_port_xla_sage_llm", _xla_sage)
    prev_j, prev_t = jmodels.get_attention_backend(), models.get_attention_backend()
    yield
    jmodels.set_attention_backend(prev_j)
    models.set_attention_backend(prev_t)


TOL = {"fp32": (0.99999, 5e-3), "bf16": (0.999, 1e-1)}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(window=None, seed=1, dtype="fp32"):
    jdt, tdt = DTYPES[dtype]
    jm = jmodels.CausalLM(_tiny(J_CONFIGS, window=window), dtype=jdt)
    toks = np.random.default_rng(0).integers(0, 128, (2, PROMPT + STEPS)).astype(np.int32)
    # the JAX "sage" raises at this revision, and its "reference" takes no
    # window: initialise through the window-free model (the same parameters)
    jmodels.set_attention_backend("reference")
    params = jmodels.CausalLM(_tiny(J_CONFIGS)).init(jax.random.PRNGKey(seed), jnp.array(toks[:, :8]))
    sd = llm_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    tm = generate.load_llm(_tiny(models.MODEL_CONFIGS, window=window), device="cpu",
                           state_dict=sd, dtype=tdt)
    return jm, params, tm, toks


def _close(t, j, dtype="fp32"):
    t, j = t.float(), torch.tensor(np.asarray(j, np.float32))
    cos = cosine_similarity(t, j)
    err = ((t - j).abs().max() / j.abs().max()).item()
    floor, limit = TOL[dtype]
    assert cos >= floor and err <= limit, (cos, err)


def _run(jm, params, tm, toks, *, cache, bits, chunked=0, dtype="fp32"):
    """Prompt (one shot, or ``chunked``-token extend blocks) and STEPS
    teacher-forced decode steps on both sides; every step's logits compared."""
    b = toks.shape[0]
    table = np.random.default_rng(2).permutation(b * MAX_LEN // PAGE).reshape(b, -1)
    if cache == "paged":
        jc = jm.init_paged_caches(b, MAX_LEN, page_size=PAGE, page_table=jnp.array(table),
                                  bits=bits)
        tc = tm.init_paged_caches(b, MAX_LEN, page_size=PAGE,
                                  page_table=torch.tensor(table, dtype=torch.int32), bits=bits)
    else:
        jc, tc = jm.init_caches(b, MAX_LEN, bits=bits), tm.init_caches(b, MAX_LEN, bits=bits)
    jl, tl = jnp.zeros((b,), jnp.int32), torch.zeros(b, dtype=torch.int32)
    with torch.inference_mode():
        blocks = [(i, chunked) for i in range(0, PROMPT, chunked)] if chunked else [(0, PROMPT)]
        for i, n in blocks:
            jlog, jc = jm.apply(params, jnp.array(toks[:, i:i + n]), caches=jc, lengths=jl,
                                decode=bool(chunked))
            tlog, tc = tm(torch.tensor(toks[:, i:i + n]), caches=tc, lengths=tl,
                          decode=bool(chunked))
            _close(tlog, jlog, dtype)
            jl, tl = jl + n, tl + n
        for s in range(PROMPT, PROMPT + STEPS):
            jlog, jc = jm.apply(params, jnp.array(toks[:, s:s + 1]), caches=jc, lengths=jl,
                                decode=True)
            tlog, tc = tm(torch.tensor(toks[:, s:s + 1]), caches=tc, lengths=tl, decode=True)
            _close(tlog, jlog, dtype)
            jl, tl = jl + 1, tl + 1


@pytest.mark.parametrize("cache,bits,dtype", [
    ("dense", 8, "fp32"), ("paged", 8, "fp32"), ("dense", 4, "fp32"), ("paged", 4, "fp32"),
    ("dense", 8, "bf16"), ("paged", 4, "bf16")])
@pytest.mark.parametrize("prefill", ["reference", "sage"])
def test_cached_decode_matches_flax(cache, bits, dtype, prefill):
    jm, params, tm, toks = _pair(dtype=dtype)
    jmodels.set_attention_backend("reference" if prefill == "reference"
                                  else "torch_port_xla_sage_llm")
    models.set_attention_backend(prefill)
    _run(jm, params, tm, toks, cache=cache, bits=bits, dtype=dtype)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_windowed_chunked_prefill_matches_flax(cache):
    """A sliding window of 8: extend blocks of 8 tokens and decode steps,
    all through the windowed decode kernels (10 and 12)."""
    jm, params, tm, toks = _pair(window=8)
    _run(jm, params, tm, toks, cache=cache, bits=8, chunked=8)


def test_full_prefill_without_cache_matches_flax():
    jm, params, tm, toks = _pair()
    jmodels.set_attention_backend("reference")
    models.set_attention_backend("reference")
    with torch.inference_mode():
        _close(tm(torch.tensor(toks)), jm.apply(params, jnp.array(toks)))


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_windowed_one_shot_prefill_matches_flax(cache):
    """A sliding window of 8 over a 16-token prompt in one prefill through
    the windowed attention ("sage": the masked forward with ``window``),
    then decode steps through the windowed decode kernels."""
    jm, params, tm, toks = _pair(window=8)
    jmodels.set_attention_backend("torch_port_xla_sage_llm")
    models.set_attention_backend("sage")
    _run(jm, params, tm, toks, cache=cache, bits=8)


def test_refusals():
    """What the model refuses: decoding without caches."""
    _, _, tm, toks = _pair(window=8)
    models.set_attention_backend("sage")
    with torch.inference_mode():
        with pytest.raises(ValueError, match="decode=True requires caches"):
            tm(torch.tensor(toks[:, :1]), decode=True)
        # the windowed model's one-shot forward without caches runs
        assert torch.isfinite(tm(torch.tensor(toks))).all()


def test_generate_on_cpu():
    """``generate`` greedy-decodes from the caches; its last step's logits
    agree with a refeed of the generated sequence through exact attention
    (cosine >= 0.999: the cached path quantizes K, V and P)."""
    cfg = _tiny(models.MODEL_CONFIGS)
    model = generate.load_llm(cfg, device="cpu", seed=3, dtype=torch.float32)
    prompt = torch.tensor(np.random.default_rng(4).integers(0, 128, (2, PROMPT)))
    models.set_attention_backend("sage")
    for cache in ("dense", "paged"):
        out = generate.generate(model, prompt, 4, cache=cache, max_len=MAX_LEN, page_size=PAGE)
        assert out["tokens"].shape == (2, 5) and out["device"] == "cpu"
        assert len(out["step_ms"]) == 4 and out["tokens_per_s"] > 0
        seq = torch.cat([prompt, out["tokens"][:, :-1]], dim=1)
        models.set_attention_backend("reference")
        with torch.inference_mode():
            ref = model(seq)[:, PROMPT - 1:]
        models.set_attention_backend("sage")
        assert torch.equal(ref[:, 0].argmax(dim=-1), out["tokens"][:, 0]), cache
        assert cosine_similarity(out["logits"][:, -1], ref[:, -1]) >= 0.999, cache
