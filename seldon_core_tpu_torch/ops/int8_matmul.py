"""Int8 weight-only matmul (W8A16 GEMM): a CUDA C++ kernel for Hopper, and
its plain PyTorch version.

Replaces the TPU kernel ``seldon_core_tpu/ops/pallas_int8.py``
(``int8_matmul``, Pallas body ``_kernel``): ``x @ (q * scale)`` with the
weight tile crossing device memory as int8 and dequantized next to the
matrix unit, float32 accumulation. In the port it is the serving path of
``quantize="int8"``: every projection of the transformer and its lm_head go
through ``ops/quantize.quantized_matmul`` -> ``int8_dense`` -> here.

What bounds it on the card: at decode (M = 8 slots) bytes, the K x N int8
weight read once; at a 256-token prefill chunk the tensor-core operations.
The source note in ``csrc/int8_matmul.cu`` says how the design serves both,
and why scaling in the epilogue computes the TPU kernel's function.

The wrapper picks a split of K (``_split_k``): at decode the grid of 16 x 32
output tiles is about one block per SM (N = 4096 gives 128 tiles on 132
SMs), too few loads in flight to stream the weight, so the K range is cut
into splits whose float32 partials a second small kernel sums, scales and
casts. Once the output tiles alone fill the card several times over, there
is one split and no workspace.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# the kernel's tile (csrc/int8_matmul.cu: BM, BN, BK)
BM, BN, BK = 16, 32, 128
# blocks per SM the split of K aims at
_WAVES = 4
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    out_dtype=None) -> torch.Tensor:
    """Plain version: ``x.float() @ (q.float() * scale)`` cast to
    ``out_dtype`` (default ``x.dtype``) — the JAX package's expression."""
    out_dtype = out_dtype or x.dtype
    return (x.float() @ (q.float() * scale.float())).to(out_dtype)


def _split_k(m: int, n: int, k: int, sms: int):
    """(splits, k tiles per split) for an [m, k] x [k, n] product on a card
    of ``sms`` SMs: enough splits to put about ``_WAVES`` blocks on every
    SM, never an empty one."""
    tiles = -(-m // BM) * -(-n // BN)
    k_tiles = max(-(-k // BK), 1)
    splits = min(k_tiles, max(1, -(-_WAVES * sms // tiles)))
    per = -(-k_tiles // splits)
    return -(-k_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    """SMs of card ``device_index``, asked once: a decode step launches
    this kernel 225 times."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _kernel_fn():
    lib_fn = _kernel_fn.fn
    if lib_fn is None:
        from seldon_core_tpu_torch.ops._build import load_library

        lib_fn = load_library("int8_matmul").int8_matmul_bf16
        lib_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib_fn.restype = ctypes.c_int
        _kernel_fn.fn = lib_fn
    return lib_fn


_kernel_fn.fn = None


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x [M, K] float; q [K, N] int8; scale [N] float32 -> [M, N] in
    ``out_dtype`` (default ``x.dtype``): ``x @ (q * scale)`` with float32
    accumulation.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation), or raise. The kernel takes bf16
    ``x`` and writes bf16 or float32: the lm_head's ``x.float() @ W`` is
    bf16 in, float32 out, since ``x.float()`` of a bf16 ``x`` is exact."""
    if (x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]
            or tuple(scale.shape) != (q.shape[1],)):
        raise ValueError(f"int8_matmul: shapes x={tuple(x.shape)} q={tuple(q.shape)} "
                         f"scale={tuple(scale.shape)}: expected [M, K], [K, N], [N]")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul kernel takes bf16 x, int8 q, float32 scale; got "
                        f"{x.dtype}/{q.dtype}/{scale.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_matmul kernel writes bf16 or float32, not {out_dtype}")
    for t in (q, scale):
        if t.device != x.device:
            raise ValueError("int8_matmul: x, q and scale must share a device")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul: x, q and scale must be contiguous")
    m, k = x.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    from seldon_core_tpu_torch.ops._build import launch

    splits, per = _split_k(m, n, k, _sm_count(x.device.index))
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    launch(_kernel_fn(), x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(),
           out.data_ptr(), None if partial is None else partial.data_ptr(), m, n, k,
           int(out_dtype == torch.float32), splits, per)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_dense(x: torch.Tensor, qt, out_dtype=None) -> torch.Tensor:
    """Apply a quantized [K, N] weight (``ops/quantize.QuantizedTensor``:
    ``q``, ``scale``, ``orig_dtype``) to activations [..., K]; leading dims
    are flattened around the kernel. Output dtype defaults to the weight's
    ``orig_dtype``, as in the JAX package."""
    out_dtype = out_dtype or qt.orig_dtype
    lead = x.shape[:-1]
    out = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), qt.q, qt.scale, out_dtype)
    return out.reshape(*lead, out.shape[-1])


__all__ = ["int8_dense", "int8_matmul", "int8_matmul_ref"]
