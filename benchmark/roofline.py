"""The counting rules of the rooflines and of ``mfu``, and the peaks they
are held to.

Peaks are the NVIDIA H100 SXM data sheet's dense rates (no sparsity):
989 TFLOP/s bf16, 1,979 TOP/s int8 and 1,979 TFLOP/s e4m3, 3.35 TB/s of
HBM.  The counts depend on the shapes and on the cell's declared
precisions only, never on which kernel runs or what it recomputes:

* the attention forward of a call (b, h, s_q, s_k, d): Q.K^T,
  2 b h s_q s_k d operations at the int8 peak, and P.V, as many at the peak
  of the P.V type the cell's attention backend declares (:data:`PV_TYPE`); q (bf16), the K codes (int8) and V (the P.V
  type) read once and o (bf16) written once; the bound is the larger of
  the summed operation times and the bytes over the bandwidth;
* the attention backward: five products, S = Q.K^T once at int8, dP, dV,
  dQ and dK at bf16; q, k, v, o, dO (bf16) and the LSE (fp32) read once,
  dq, dk, dv (bf16) written once;
* ``mfu``: every linear layer 2 tokens in out at bf16 (x3 in training:
  the forward and the two backward products), every attention its forward
  products (and its backward ones in training); elementwise work is not
  counted.
"""

from __future__ import annotations

import dataclasses

PEAK = {"int8": 1979e12, "e4m3": 1979e12, "bf16": 989e12}
BANDWIDTH = 3.35e12
SIZE = {"int8": 1, "e4m3": 1, "bf16": 2, "fp32": 4}
# the P.V type each attention backend of a traffic mix declares
PV_TYPE = {"sage": "bf16", "sage_fp8": "e4m3"}


def pv_type(backend: str) -> str:
    """The P.V type the backend ``backend`` declares."""
    if backend not in PV_TYPE:
        raise ValueError(f"no P.V type known for the attention backend {backend!r}; "
                         f"have {sorted(PV_TYPE)}")
    return PV_TYPE[backend]


@dataclasses.dataclass(frozen=True)
class Bound:
    ops_ms: float
    bytes_ms: float

    @property
    def ms(self) -> float:
        return max(self.ops_ms, self.bytes_ms)

    @property
    def by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"


def _product(b, h, sq, sk, d) -> float:
    return 2.0 * b * h * sq * sk * d


def attention_forward(b, h, sq, sk, d, pv: str = "bf16") -> Bound:
    p = _product(b, h, sq, sk, d)
    ops_s = p / PEAK["int8"] + p / PEAK[pv]
    nbytes = b * h * (sq * d * (SIZE["bf16"] * 2) + sk * d * (SIZE["int8"] + SIZE[pv]))
    return Bound(ops_s * 1e3, nbytes / BANDWIDTH * 1e3)


def attention_backward(b, h, sq, sk, d) -> Bound:
    p = _product(b, h, sq, sk, d)
    ops_s = p / PEAK["int8"] + 4 * p / PEAK["bf16"]
    nbytes = b * h * (4 * sq * d * SIZE["bf16"] + sq * SIZE["fp32"] + 4 * sk * d * SIZE["bf16"])
    return Bound(ops_s * 1e3, nbytes / BANDWIDTH * 1e3)


def linear_ms(tokens, d_in, d_out) -> float:
    return 2.0 * tokens * d_in * d_out / PEAK["bf16"] * 1e3


def step_matrix_ms(linears, attentions, pv: str, training: bool) -> float:
    """The least time one step's matrix products take at the peaks of their
    declared precisions: ``linears`` (tokens, in, out) and ``attentions``
    (b, h, s_q, s_k, d) of one forward."""
    ms = sum(linear_ms(*x) for x in linears) * (3 if training else 1)
    for shape in attentions:
        ms += attention_forward(*shape, pv=pv).ops_ms
        if training:
            ms += attention_backward(*shape).ops_ms
    return ms
