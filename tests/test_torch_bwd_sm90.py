"""The Python side of kernels 7-8 (the backward, dQ and dK/dV) as TMA-fed
``wgmma`` kernels with a bias and without, on the CPU.

* :func:`attention_bwd_cuda.route` at head dims 64, 128 and 256, without a
  bias and with an fp32 or a bf16 one: the library and both entry points
  each wrapper calls, all in ``_build.SIGNATURES``, and the kernel they
  reach, the ``wgmma`` kernels of ``csrc/attention_bwd.cu`` (a ``BIAS``
  template argument picks the bias instances); the source holds no
  ``mma.sync`` kernel any more, and at 256 a bias call is one dK/dV launch.
* :func:`attention_bwd_cuda.bias_reads`, the host's choice of how the
  kernels read a bias: by TMA where a row of ``sk`` elements is a multiple of 16
  bytes and the base 16-byte aligned (a TMA map's rule), else by each
  thread's loads, at ``sk`` in {4096, 4000, 3001, 4097} for both dtypes; and
  the ``bias_kind`` argument the wrappers pass (bit 0 bf16, bit 1 loads).
* The bias wrappers' CPU path at a length of each form of dQ's reads,
  fp32 and bf16, with a row biased to -inf: what the kernels must write
  (dBias's causal zeros, the dead row's zeros).  The plain versions are
  held to the JAX fused bias backward by ``tests/test_torch_bias_grad.py``;
  the kernels themselves run only on the card (``chip_smoke.py``,
  ``tools/ab_attention_bwd.py``).
"""

import re

import numpy as np
import pytest
import torch

from sageattention_tpu_torch.ops import _build, attention_bwd_cuda as bwd

SOURCE = (_build.CSRC / "attention_bwd.cu").read_text()


@pytest.mark.parametrize("bias_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_route(d, bias_dtype):
    lib, dq, dkv, kernel = bwd.route(d, bias_dtype)
    sfx = "" if bias_dtype is None else "_bias"
    assert (lib, dq, dkv, kernel) == ("attention_bwd", "sage_attn_bwd_dq" + sfx,
                                      "sage_attn_bwd_dkv" + sfx, "wgmma")
    assert dq in _build.SIGNATURES[lib] and dkv in _build.SIGNATURES[lib]
    # each entry point dispatches to the TMA-fed wgmma kernels, a bias to
    # their BIAS instances
    body = SOURCE[SOURCE.index(f'extern "C" int {dq}('):]
    body = body[:body.index("\n}\n")]
    want = "kNoBias" if bias_dtype is None else "kBiasTma"
    assert f"run_dq<{want}>" in body
    assert "sage_attn_bwd_dq_tma_kernel" in SOURCE and "sage_attn_bwd_dkv_tma_kernel" in SOURCE


@pytest.mark.parametrize("d", [32, 96, 320])
def test_route_refuses_other_head_dims(d):
    with pytest.raises(ValueError, match="64, 128 or 256"):
        bwd.route(d)


def test_route_refuses_other_bias_dtypes():
    with pytest.raises(ValueError, match="fp32 or bf16"):
        bwd.route(128, torch.float16)


@pytest.mark.parametrize("name", ["sage_attn_bwd_dq_kernel", "sage_attn_bwd_dkv_kernel",
                                  "DqLayout", "DkvLayout", "load_rows", "launch_dq_bias",
                                  "launch_dkv_part", "launch_dkv_bias"])
def test_mma_sync_bias_kernels_are_gone(name):
    assert not re.search(rf"\b{name}\b", SOURCE)


def test_no_mma_sync_product_in_the_backward():
    # every product is a wgmma (mma_sm90.cuh is included for pack_bf16 only)
    assert not re.search(r"\bmma_(s8|bf16|a_rows)\s*\(", SOURCE)
    assert "ldsm_x4_trans" not in SOURCE and "wgmma_bf16_rs_mn" in SOURCE


def test_one_dkv_launch_with_a_bias_at_256():
    """The dK/dV bias entry point runs one launch at every head dim (one
    ``run_dkv`` call on either form of reading the bias, and no dV-only
    launch): the D = 256 kernel's dV and dK warpgroups share the Q tiles
    and read the bias in the same launch, where the threads load it."""
    body = SOURCE[SOURCE.index('extern "C" int sage_attn_bwd_dkv_bias('):]
    body = body[:body.index("\n}\n")]
    assert re.search(r"return tma \? run_dkv<kBiasTma>\(.*\)\s*: run_dkv<kBiasLoads>\(", body, re.S)
    assert "d != 256" in body
    assert "kDV>(" not in SOURCE and "PART = kDKV" not in SOURCE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [4096, 4000, 3001, 4097])
def test_bias_reads(sk, dtype):
    size = 4 if dtype == torch.float32 else 2
    want = "tma" if sk * size % 16 == 0 else "loads"
    # 4096 takes TMA in both dtypes, 4000 too (16,000 / 8,000 bytes a row),
    # 3001 and 4097 the loads
    assert want == ("tma" if sk in (4096, 4000) else "loads")
    assert bwd.bias_reads(sk, dtype, 0) == want
    assert bwd.bias_reads(sk, dtype, 256) == want
    # a base off 16-byte alignment cannot be mapped
    assert bwd.bias_reads(sk, dtype, 8) == "loads"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [4000, 3001])
def test_bias_kind(sk, dtype):
    bias = torch.zeros(1, 2, 8, sk, dtype=dtype)
    kind = bwd._bias_kind(bias)
    assert kind & 1 == (dtype == torch.bfloat16)
    assert bool(kind & 2) == (bwd.bias_reads(sk, dtype, bias.data_ptr()) == "loads")
    assert kind >> 2 == 0


def _operands(rng, b, hq, hkv, s, d, bias_dtype, dead):
    """Quantized backward operands with a consistent biased causal forward:
    lse2 of the same codes and bias (-inf on a row whose bias is -inf on
    every key)."""
    t = dict(q_i8=torch.from_numpy(rng.integers(-127, 128, (b, hq, s, d)).astype(np.int8)),
             k_i8=torch.from_numpy(rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8)),
             q_scale=torch.from_numpy((rng.random((b, hq, s)) * 1e-3 + 1e-4).astype(np.float32)),
             k_scale=torch.from_numpy(
                 (rng.random((b, hkv, -(-s // 128))) * 1e-2 + 1e-3).astype(np.float32)))
    for name, h in (("k_sm", hkv), ("v", hkv), ("q_bf", hq), ("do", hq)):
        t[name] = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).to(
            torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal((b, hq, s, s)).astype(np.float32)).to(bias_dtype)
    bias[0, dead[0], dead[1]] = -torch.inf
    rep = hq // hkv
    k_rows = bwd._k_rows(t["k_scale"], s).repeat_interleave(rep, 1)
    l2 = (t["q_i8"].float() @ t["k_i8"].float().repeat_interleave(rep, 1).transpose(-1, -2)
          ) * (t["q_scale"][..., None] * k_rows[..., None, :])
    l2 = torch.clamp(l2 + bias.float() * 1.4426950408889634, min=-1e30)
    l2 = l2.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -torch.inf)
    lse2 = torch.logsumexp(l2 * np.log(2.0), dim=-1) / np.log(2.0)
    t["lse2"] = torch.where((l2 <= -1e30).all(-1), -torch.inf, lse2).float()
    t["dvec"] = torch.from_numpy((rng.standard_normal((b, hq, s)) * 1e-2).astype(np.float32))
    return t, bias


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [256, 203])
def test_cpu_bias_wrappers_write_what_the_kernels_write(s, bias_dtype):
    """The wrappers' CPU path (the plain versions the card's kernels are
    held to), causal, at a length whose dQ reads the bias by TMA (256) and
    one that takes the loads (203 tokens: 812 / 406 bytes a row), with a
    row biased to -inf: dBias in the bias's dtype with exact zeros right of
    the diagonal (the kernel writes them itself) and on the dead row, whose
    dq is 0 too; dq, dk and dv finite."""
    rng = np.random.default_rng(s + (bias_dtype == torch.bfloat16))
    ops, bias = _operands(rng, 1, 2, 1, s, 64, bias_dtype, dead=(1, 77))
    assert bwd.bias_reads(s, bias_dtype) == ("tma" if s == 256 else "loads")
    assert torch.isneginf(ops["lse2"][0, 1, 77])
    kw = dict(is_causal=True, sm_scale=0.125, bias=bias)
    dq, dbias = bwd.sage_attention_bwd_dq(
        *[ops[n] for n in ("q_i8", "q_scale", "k_i8", "k_scale", "k_sm", "v", "do", "lse2",
                           "dvec")], need_dbias=True, **kw)
    dk, dv = bwd.sage_attention_bwd_dkv(
        *[ops[n] for n in ("q_i8", "q_scale", "q_bf", "k_i8", "k_scale", "v", "do", "lse2",
                           "dvec")], **kw)
    assert dbias.dtype == bias_dtype and dbias.shape == bias.shape
    assert all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv, dbias))
    assert (dq[0, 1, 77] == 0).all() and (dbias[0, 1, 77] == 0).all()
    assert (torch.triu(dbias.float(), 1) == 0).all() and (dbias.float().abs().sum() > 0)
