"""K3, K4, K5: AdaAttN softmax attention moments and their gradient —
hand-written CUDA kernels + their plain PyTorch versions.

Counterpart of ``vst_tpu/kernels/adaattn_attention.py::
softmax_attention_moments_pallas`` and its custom VJP:
- K3 (``_fwd_kernel``, source ``csrc/adaattn_fwd.cu``): M1 = softmax(QKᵀ)·V,
  M2 = softmax(QKᵀ)·(V∘V) and the row logsumexp L, without materializing
  the (n×m) attention map;
- K4 (``_bwd_dq_kernel``, ``csrc/adaattn_bwd.cu``): dQ = dS·K;
- K5 (``_bwd_dkv_kernel``, ``csrc/adaattn_bwd.cu``): dK = dSᵀ·Q and
  dV = Aᵀ·dM1 + 2V∘(Aᵀ·dM2);
with A = exp(S − L), dA = dM1·Vᵀ + dM2·(V∘V)ᵀ, dS = A∘(dA − D) and the row
term D = Σ_c(dM1∘M1 + dM2∘M2), taken in float32 outside the kernels as
JAX does.  The backward never materializes the map either.

``softmax_attention_moments`` is ``SoftmaxAttentionMoments.apply``: K3
forward, K4/K5 backward.  Every softmax ``attention_moments`` of the
port's AdaAttN model outside mode ``"exact"`` runs through it
(``models/adaattn.py``).  Each wrapper launches its kernel for CUDA
tensors (or raises) and takes its plain version only for CPU tensors.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from vst_tpu_torch.kernels import _build

MAX_D_BF16 = 1472   # K3's whole (64 × d) bf16 Q tile stays in shared memory


@functools.cache
def _kernel():
    fn = _build.load("adaattn_fwd").vst_k3_attention_moments
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel(name):
    fn = getattr(_build.load("adaattn_bwd"), name)
    n_ptr = 8 if name == "vst_k4_attention_dq" else 9
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------- plain versions

def softmax_attention_moments_plain(q, k, v, chunk: int = 1024):
    """Plain version of K3, ``chunk`` query rows at a time: float32
    scores, P = exp(S − rowmax) rounded to the input type before the two
    products (the kernel's rounding point), row sums of the unrounded P,
    V∘V formed in float32 and rounded to the input type, and L by
    ``torch.logsumexp``.  Returns (M1, M2) in q.dtype and L (b, n, 1)
    float32."""
    n = q.shape[1]
    vf = v.float()
    wf = (vf * vf).to(v.dtype).float()
    kt = k.float().transpose(1, 2)
    m1, m2, lse = [], [], []
    for i in range(0, n, chunk):
        s = torch.matmul(q[:, i:i + chunk].float(), kt)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        inv = 1.0 / p.sum(dim=-1, keepdim=True)
        pr = p.to(q.dtype).float()
        m1.append(torch.matmul(pr, vf) * inv)
        m2.append(torch.matmul(pr, wf) * inv)
        lse.append(torch.logsumexp(s, dim=-1, keepdim=True))
    return (torch.cat(m1, 1).to(q.dtype), torch.cat(m2, 1).to(q.dtype),
            torch.cat(lse, 1))


def row_term(m1, m2, dm1, dm2):
    """D = Σ_c(dM1∘M1 + dM2∘M2) in float32, (b, n, 1): the softmax row
    correction (JAX ``_backward``)."""
    return ((dm1.float() * m1.float()).sum(-1, keepdim=True)
            + (dm2.float() * m2.float()).sum(-1, keepdim=True))


def _bwd_plain(q, k, v, lse, dd, dm1, dm2, want_q=True, want_kv=True,
               chunk: int = 1024):
    """The JAX ``_backward`` formulas, ``chunk`` query rows at a time, in
    float32 with the kernels' rounding points: V∘V formed in float32 and
    rounded to v's type, A and dS rounded to q's type before their
    products.  dm1, dm2 are in q's type.  Returns (dQ or None, dK or None,
    dV or None)."""
    n = q.shape[1]
    kf, vf = k.float(), v.float()
    wf = (vf * vf).to(v.dtype).float()
    kt, vt, wt = kf.transpose(1, 2), vf.transpose(1, 2), wf.transpose(1, 2)
    dq, dk, dv1, dv2 = [], 0.0, 0.0, 0.0
    for i in range(0, n, chunk):
        qi = q[:, i:i + chunk].float()
        d1, d2 = dm1[:, i:i + chunk].float(), dm2[:, i:i + chunk].float()
        a = torch.exp(torch.matmul(qi, kt) - lse[:, i:i + chunk])
        da = torch.matmul(d1, vt) + torch.matmul(d2, wt)
        ds = (a * (da - dd[:, i:i + chunk])).to(q.dtype).float()
        if want_q:
            dq.append(torch.matmul(ds, kf))
        if want_kv:
            ar = a.to(q.dtype).float().transpose(1, 2)
            dk = dk + torch.matmul(ds.transpose(1, 2), qi)
            dv1 = dv1 + torch.matmul(ar, d1)
            dv2 = dv2 + torch.matmul(ar, d2)
    out_q = torch.cat(dq, 1).to(q.dtype) if want_q else None
    if not want_kv:
        return out_q, None, None
    return out_q, dk.to(q.dtype), (dv1 + 2.0 * vf * dv2).to(v.dtype)


def softmax_attention_dq_plain(q, k, v, lse, dd, dm1, dm2):
    """Plain version of K4 (``softmax_attention_dq``)."""
    return _bwd_plain(q, k, v, lse, dd, dm1, dm2, want_kv=False)[0]


def softmax_attention_dkv_plain(q, k, v, lse, dd, dm1, dm2):
    """Plain version of K5 (``softmax_attention_dkv``)."""
    return _bwd_plain(q, k, v, lse, dd, dm1, dm2, want_q=False)[1:]


def softmax_attention_moments_bwd_plain(q, k, v, m1, m2, lse, dm1, dm2):
    """Plain backward of the moments: (dQ, dK, dV) for the cotangents
    (dM1, dM2) of ``softmax_attention_moments(q, k, v)`` = (m1, m2, lse).
    dQ and dK come back in q's dtype, dV in v's."""
    dd = row_term(m1, m2, dm1, dm2)
    return _bwd_plain(q, k, v, lse, dd, dm1.to(q.dtype), dm2.to(q.dtype))


# ------------------------------------------------------------ kernel checks

def _rows_contiguous(t):
    """Each batch entry is a row-major (rows, width) matrix."""
    return t.stride(2) == 1 and (t.shape[1] == 1 or t.stride(1) == t.shape[2])


def _check(q, k, v, what="softmax_attention_moments"):
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{what}: q, k, v must be on one CUDA device (q "
                         f"{q.device}, k {k.device}, v {v.device})")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{what}: dtypes q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}")
    if (q.dim() != 3 or k.dim() != 3 or v.dim() != 3
            or k.shape[0] != q.shape[0] or v.shape[0] != q.shape[0]
            or k.shape[2] != q.shape[2] or v.shape[1] != k.shape[1]
            or min(q.shape) < 1 or min(k.shape) < 1 or v.shape[2] < 1):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not all(_rows_contiguous(t) for t in (q, k, v)):
        raise ValueError(f"{what}: rows of q, k, v must be contiguous (a "
                         "batch stride of 0 is fine)")
    if q.dtype == torch.bfloat16:
        d, c = q.shape[2], v.shape[2]
        if d % 8 or c % 8 or d > MAX_D_BF16:
            raise ValueError(f"{what}: bf16 needs d and c multiples of 8 and "
                             f"d <= {MAX_D_BF16}, got d={d}, c={c}")
        if any(t.data_ptr() % 16 or t.stride(0) % 8 for t in (q, k, v)):
            raise ValueError(f"{what}: bf16 rows must be 16-byte aligned")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------------------------------------ kernels

def _moments_fwd(q, k, v):
    """K3: (M1, M2, L) for q (b, n, d), k (b, m, d), v (b, m, c)."""
    if q.device.type == "cpu":
        return softmax_attention_moments_plain(q, k, v)
    _check(q, k, v)
    b, n, d = q.shape
    m, c = k.shape[1], v.shape[2]
    m1 = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    m2 = torch.empty_like(m1)
    lse = torch.empty((b, n, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       m1.data_ptr(), m2.data_ptr(), lse.data_ptr(),
                       b, n, m, d, c, q.stride(0), k.stride(0), v.stride(0),
                       int(q.dtype == torch.bfloat16), _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"K3 softmax_attention_moments launch failed: "
                           f"CUDA error {rc}")
    softmax_attention_moments.launches += 1
    return m1, m2, lse


def _check_bwd(q, k, v, lse, dd, dm1, dm2, what):
    _check(q, k, v, what)
    b, n = q.shape[:2]
    c = v.shape[2]
    for name, t, shape, dtype in (("lse", lse, (b, n, 1), torch.float32),
                                  ("D", dd, (b, n, 1), torch.float32),
                                  ("dm1", dm1, (b, n, c), q.dtype),
                                  ("dm2", dm2, (b, n, c), q.dtype)):
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def softmax_attention_dq(q, k, v, lse, dd, dm1, dm2):
    """K4: dQ (b, n, d) in q's dtype, from the forward's inputs, its L,
    the row term D (``row_term``) and the cotangents dM1, dM2 in q's
    dtype (all (b, n, ·), contiguous)."""
    if q.device.type == "cpu":
        return softmax_attention_dq_plain(q, k, v, lse, dd, dm1, dm2)
    _check_bwd(q, k, v, lse, dd, dm1, dm2, "softmax_attention_dq")
    b, n, d = q.shape
    m, c = k.shape[1], v.shape[2]
    dq = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _bwd_kernel("vst_k4_attention_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dm1.data_ptr(),
            dm2.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
            b, n, m, d, c, q.stride(0), k.stride(0), v.stride(0),
            int(q.dtype == torch.bfloat16), _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"K4 softmax_attention_dq launch failed: CUDA "
                           f"error {rc}")
    softmax_attention_dq.launches += 1
    return dq


def softmax_attention_dkv(q, k, v, lse, dd, dm1, dm2):
    """K5: dK (b, m, d) in q's dtype and dV (b, m, c) in v's, same inputs
    as ``softmax_attention_dq``.  A K or V broadcast over the batch
    (stride 0) gets a full-batch gradient; autograd sums it through the
    ``expand``."""
    if q.device.type == "cpu":
        return softmax_attention_dkv_plain(q, k, v, lse, dd, dm1, dm2)
    _check_bwd(q, k, v, lse, dd, dm1, dm2, "softmax_attention_dkv")
    b, n, d = q.shape
    m, c = k.shape[1], v.shape[2]
    dk = torch.empty((b, m, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, m, c), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _bwd_kernel("vst_k5_attention_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dm1.data_ptr(),
            dm2.data_ptr(), lse.data_ptr(), dd.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, n, m, d, c, q.stride(0), k.stride(0),
            v.stride(0), int(q.dtype == torch.bfloat16), _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"K5 softmax_attention_dkv launch failed: CUDA "
                           f"error {rc}")
    softmax_attention_dkv.launches += 1
    return dk, dv


class SoftmaxAttentionMoments(torch.autograd.Function):
    """K3 forward; K4 (dQ) and K5 (dK, dV) backward.  Saves (q, k, v, M1,
    M2, L).  L is an output too, but carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        m1, m2, lse = _moments_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, m1, m2, lse)
        ctx.mark_non_differentiable(lse)
        return m1, m2, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, dm1, dm2, _dlse):
        q, k, v, m1, m2, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad
        dd = row_term(m1, m2, dm1, dm2)
        dm1 = dm1.to(q.dtype).contiguous()
        dm2 = dm2.to(q.dtype).contiguous()
        dq = dk = dv = None
        if need_q:
            dq = softmax_attention_dq(q, k, v, lse, dd, dm1, dm2)
        if need_k or need_v:
            dk, dv = softmax_attention_dkv(q, k, v, lse, dd, dm1, dm2)
        return dq, dk if need_k else None, dv if need_v else None


def softmax_attention_moments(q, k, v):
    """q (b, n, d), k (b, m, d), v (b, m, c) → M1, M2 (b, n, c) in q.dtype
    and L (b, n, 1) float32 (natural log); differentiable in q, k and v.

    All float32 (CUDA cores, true float32) or all bfloat16 (tensor cores;
    d, c multiples of 8, d ≤ 1472).  Rows must be contiguous; K and V may
    be broadcast over the batch with ``expand`` (batch stride 0), which the
    kernels read in place."""
    return SoftmaxAttentionMoments.apply(q, k, v)


softmax_attention_moments.launches = 0
softmax_attention_dq.launches = 0
softmax_attention_dkv.launches = 0
