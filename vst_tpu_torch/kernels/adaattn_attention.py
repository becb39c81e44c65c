"""K3: AdaAttN softmax attention moments (forward) — hand-written CUDA
kernel + its plain PyTorch version.

Counterpart of the forward of
``vst_tpu/kernels/adaattn_attention.py::softmax_attention_moments_pallas``
(``_fwd_kernel``): M1 = softmax(QKᵀ)·V, M2 = softmax(QKᵀ)·(V∘V) and the
row logsumexp L, without materializing the (n×m) attention map.  Every
softmax ``attention_moments`` of the port's AdaAttN model outside mode
``"exact"`` runs through it on the card (``models/adaattn.py``).  The
kernel source is ``csrc/adaattn_fwd.cu``.

``softmax_attention_moments`` launches the kernel for CUDA tensors (or
raises) and takes the plain version only for CPU tensors.  Neither has a
backward yet (the TPU kernel's K4/K5): a call that would need a gradient
raises.
"""

import ctypes
import functools

import torch

from vst_tpu_torch.kernels import _build

MAX_D_BF16 = 1472   # the kernel's whole (64 × d) bf16 Q tile stays in shared memory


@functools.cache
def _kernel():
    fn = _build.load("adaattn_fwd").vst_k3_attention_moments
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _no_grad_needed(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "softmax_attention_moments has no backward yet (the TPU "
            "kernel's K4/K5 are not ported): run under torch.no_grad() / "
            "inference_mode(), or use attention_moments(..., mode='exact')")


def softmax_attention_moments_plain(q, k, v, chunk: int = 1024):
    """Plain version, ``chunk`` query rows at a time: float32 scores,
    P = exp(S − rowmax) rounded to the input type before the two products
    (the kernel's rounding point), row sums of the unrounded P, V∘V formed
    in float32 and rounded to the input type, and L by ``torch.logsumexp``.
    Returns (M1, M2) in q.dtype and L (b, n, 1) float32."""
    _no_grad_needed(q, k, v)
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


def _rows_contiguous(t):
    """Each batch entry is a row-major (rows, width) matrix."""
    return t.stride(2) == 1 and (t.shape[1] == 1 or t.stride(1) == t.shape[2])


def _check(q, k, v):
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("softmax_attention_moments: q, k, v must be on one "
                         f"CUDA device (q {q.device}, k {k.device}, "
                         f"v {v.device})")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"softmax_attention_moments: dtypes q {q.dtype}, "
                        f"k {k.dtype}, v {v.dtype}")
    if (q.dim() != 3 or k.dim() != 3 or v.dim() != 3
            or k.shape[0] != q.shape[0] or v.shape[0] != q.shape[0]
            or k.shape[2] != q.shape[2] or v.shape[1] != k.shape[1]
            or min(q.shape) < 1 or min(k.shape) < 1 or v.shape[2] < 1):
        raise ValueError(f"softmax_attention_moments: shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not all(_rows_contiguous(t) for t in (q, k, v)):
        raise ValueError("softmax_attention_moments: rows of q, k, v must "
                         "be contiguous (a batch stride of 0 is fine)")
    if q.dtype == torch.bfloat16:
        d, c = q.shape[2], v.shape[2]
        if d % 8 or c % 8 or d > MAX_D_BF16:
            raise ValueError(f"softmax_attention_moments: bf16 needs d and c "
                             f"multiples of 8 and d <= {MAX_D_BF16}, got "
                             f"d={d}, c={c}")
        if any(t.data_ptr() % 16 or t.stride(0) % 8 for t in (q, k, v)):
            raise ValueError("softmax_attention_moments: bf16 rows must be "
                             "16-byte aligned")


def softmax_attention_moments(q, k, v):
    """q (b, n, d), k (b, m, d), v (b, m, c) → M1, M2 (b, n, c) in q.dtype
    and L (b, n, 1) float32 (natural log).

    All float32 (CUDA cores, true float32) or all bfloat16 (tensor cores;
    d, c multiples of 8, d ≤ 1472).  Rows must be contiguous; K and V may
    be broadcast over the batch with ``expand`` (batch stride 0), which the
    kernel reads in place."""
    if q.device.type == "cpu":
        return softmax_attention_moments_plain(q, k, v)
    _no_grad_needed(q, k, v)
    _check(q, k, v)
    b, n, d = q.shape
    m, c = k.shape[1], v.shape[2]
    m1 = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    m2 = torch.empty_like(m1)
    lse = torch.empty((b, n, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       m1.data_ptr(), m2.data_ptr(), lse.data_ptr(),
                       b, n, m, d, c, q.stride(0), k.stride(0), v.stride(0),
                       int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"K3 softmax_attention_moments launch failed: "
                           f"CUDA error {rc}")
    softmax_attention_moments.launches += 1
    return m1, m2, lse


softmax_attention_moments.launches = 0
