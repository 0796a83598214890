"""K7: the collision networks' forward pass and input Jacobian, one CUDA
launch a network (`csrc/collision_nn.cu`, ``nn_kernel``).

:func:`forward_jacobian` takes a network (the self or the env collision
MLP, `models/collision_nn.py`), the rows' joint configurations ``q`` (M,
dof) and, for the env network, the obstacle, and returns ``(y (M, L),
jac (M, L, offset + cols), counts)``: the network's outputs, their
Jacobian in the input's first ``cols`` columns written from column
``offset`` on (the columns before it 0), and, with ``count=True``, each
row's hidden units with ``z > 0`` (int32), the units the kernel walked.
On CUDA tensors it launches the kernel's instantiation for the network in
float32 or float64 (or raises); on CPU tensors it runs the plain version,
:func:`forward_jacobian_plain`, the eager route the kernel replaces
(`collision_nn.mlp_forward_jacobian`).  ``interpret=True`` runs the plain
version on either device and ``interpret=False`` the kernel only
(`cuda_build.kernel_route`); ``mm_dtype="bfloat16"`` (``SQPConfig.
nn_bf16``) always runs the plain version's bf16 products, another
rounding.

The kernel reads the weights as one packed buffer (:func:`pack`), built
once for each network, dtype and device: the layers' matrices in the
order the kernel streams them through shared memory, in 16 KB chunks,
then the output layer and the biases, which it keeps resident.

No TPU kernel stands behind it: the JAX package leaves the networks to XLA.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from ..models import collision_nn as cnn
from . import cuda_build

SLOT_BYTES = 16 * 1024   # a chunk of the weight stream
EPAD = 32                # the encoded input's width, padded, in W_0's rows
ARM = 7                  # the arm's joints, the first inputs of both networks
_DTYPES = {torch.float32: 0, torch.float64: 1}   # the C entry's dtype codes
_LAYOUT = ("chunks", "chunk_elems", "resident", "row_quads", "warps",
           "threads", "shared_bytes")
_LAUNCH = ("threads", "blocks", "shared_bytes", "blocks_per_sm",
           "registers", "local_bytes", "sms")

# the networks the kernel is instantiated for, by their layers' weight
# shapes: the C entry's network id
_NETS = {((256, 21), (64, 256), (1, 64)): 0,
         ((256, 30), (256, 256), (256, 256), (256, 256), (9, 256)): 1}

# cuBLAS's order for the self network's 64 -> 1 output (a gemv) on an
# H100 with CUDA 12.8, read off the card by the rows M of the product:
# (largest M, parts, blocked, tree) -- 32 blocked chains summed as a
# halving tree to 1,727 rows, 16 interleaved chains summed in order from
# 1,738 to 34,848; from 34,859 on, 2 interleaved chains summed in order
# (the rows between were not seen: they are no multiple of 11 knots)
_GEMV_ORDERS = ((1727, 32, 1, 1), (34848, 16, 0, 0))
_GEMV_LARGE = (2, 0, 0)


def net_id(net: cnn.CollisionMLP) -> int:
    """The C entry's network id; raises for widths no kernel is
    instantiated for."""
    shapes = tuple(tuple(lin.weight.shape) for lin in net.layers)
    if shapes not in _NETS:
        raise NotImplementedError(
            f"K7: no kernel instantiation for a network of weight shapes "
            f"{shapes}; it is instantiated for {sorted(_NETS)}")
    return _NETS[shapes]


def dense_units(net: cnn.CollisionMLP) -> int:
    """The network's hidden units, summed over its hidden layers."""
    return sum(lin.out_features for lin in net.layers[:-1])


def out_order(m: int) -> tuple:
    """``(parts, blocked, tree)``: how the kernel sums the self network's
    output at ``m`` rows, as cuBLAS's gemv does (`_GEMV_ORDERS`)."""
    for top, parts, blocked, tree in _GEMV_ORDERS:
        if m <= top:
            return parts, blocked, tree
    return _GEMV_LARGE


def segments(net: cnn.CollisionMLP) -> list:
    """The matrices of the weight stream in the kernel's order: W_0' and
    W_l' (the forward, a row an input unit), then W_l from the last hidden
    layer down to W_1 (the Jacobian, a row a unit of layer l) and W_0 with
    its columns padded to ``EPAD``."""
    ws = [lin.weight for lin in net.layers]
    nh = len(ws) - 1
    w0 = ws[0].new_zeros(ws[0].shape[0], EPAD)
    w0[:, :ws[0].shape[1]] = ws[0]
    return ([w.T for w in ws[:nh]] + [ws[l] for l in range(nh - 1, 0, -1)]
            + [w0])


def pack_layout(net: cnn.CollisionMLP, dtype) -> dict:
    """The packed buffer's layout as :func:`pack` builds it: ``chunks`` of
    ``chunk_elems``, then ``resident`` elements, W_out's rows in
    ``row_quads`` quads first (the C entry's ``mpcc_nn_layout`` reports
    the same)."""
    ce = SLOT_BYTES // torch.empty((), dtype=dtype).element_size()
    shapes = [(s.shape[0], s.shape[1]) for s in segments(net)]
    chunks = sum(-(-rows // (ce // cols)) for rows, cols in shapes)
    n_out, width = net.layers[-1].weight.shape
    return dict(chunks=chunks, chunk_elems=ce,
                resident=n_out * width + dense_units(net) + n_out,
                row_quads=n_out // 4)


def row_quads(w: torch.Tensor) -> torch.Tensor:
    """An (L, n) matrix flattened as the kernel keeps J and W_out: rows 4q
    .. 4q + 3 interleaved (entry (r, i) at 4 n q + 4 i + r % 4), the rows
    past the last quad after them, one after another."""
    nq, n = w.shape[0] // 4, w.shape[1]
    quads = w[:4 * nq].reshape(nq, 4, n).transpose(1, 2).reshape(-1)
    return torch.cat([quads, w[4 * nq:].reshape(-1)])


_PACKS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def pack(net: cnn.CollisionMLP) -> torch.Tensor:
    """The network's weights as the kernel reads them, on their device in
    their dtype: each stream matrix (:func:`segments`) in whole chunks of
    ``SLOT_BYTES`` (rows padded with zeros), then W_out in row quads
    (:func:`row_quads`) and the biases b_0 .. b_out.  Built once a network
    (again if a weight changed)."""
    params = [p for lin in net.layers for p in (lin.weight, lin.bias)]
    key = (params[0].dtype, params[0].device,
           tuple(p._version for p in params))
    hit = _PACKS.get(net)
    if hit is not None and hit[0] == key:
        return hit[1]
    lay = pack_layout(net, params[0].dtype)
    ce = lay["chunk_elems"]
    parts = []
    for s in segments(net):
        rpc = ce // s.shape[1]
        rows = -(-s.shape[0] // rpc) * rpc
        buf = s.new_zeros(rows, s.shape[1])
        buf[:s.shape[0]] = s
        parts.append(buf.reshape(-1))
    parts += [row_quads(net.layers[-1].weight)]
    parts += [lin.bias for lin in net.layers]
    out = torch.cat(parts)
    _PACKS[net] = (key, out)
    return out


def forward_jacobian_plain(net: cnn.CollisionMLP, q: torch.Tensor,
                           arm_offset: int = 0, obs=None, obs_div: int = 1,
                           *, cols: int, offset: int = 0, mm_dtype=None,
                           count: bool = False):
    """Plain PyTorch version of K7 (any device): the network on ``[q[:,
    arm_offset:arm_offset + 7], obs[row // obs_div]]`` (no obs for the self
    network) by `collision_nn.mlp_forward_jacobian`, in K7's output
    layout: ``(y (M, L), jac (M, L, offset + cols), counts (M,) int32 or
    None)``."""
    m = q.shape[0]
    x = q[:, arm_offset:arm_offset + ARM]
    if obs is not None:
        rows = obs[:, None, :].expand(obs.shape[0], obs_div, 3)
        x = torch.cat([x, rows.reshape(-1, 3)[:m]], dim=-1)
    y, jac, masks = cnn.forward_jacobian_masks(net, x, mm_dtype)
    jac = jac[:, :, :cols]
    if offset:
        jac = torch.cat([jac.new_zeros(m, jac.shape[1], offset), jac],
                        dim=-1)
    counts = (sum(mk.sum(-1) for mk in masks).to(torch.int32) if count
              else None)
    return y, jac, counts


def layout(net: cnn.CollisionMLP, dtype) -> dict:
    """The kernel's own account of the pack and its block
    (`mpcc_nn_layout`): chunks, elements a chunk, resident elements,
    W_out's row stride, consumer warps, threads and shared bytes a
    block."""
    out = (ctypes.c_int * len(_LAYOUT))()
    cuda_build.check(cuda_build.library().mpcc_nn_layout(
        net_id(net), _DTYPES[dtype], out), "K7 layout")
    return dict(zip(_LAYOUT, out))


def launch_config(net: cnn.CollisionMLP, dtype, m: int) -> dict:
    """K7's launch at ``m`` rows as the card reports it
    (`mpcc_nn_launch_config`): threads and blocks, dynamic shared bytes a
    block, the blocks an SM holds at once, registers and local-memory
    bytes a thread, the card's SM count."""
    out = (ctypes.c_int * len(_LAUNCH))()
    cuda_build.check(cuda_build.library().mpcc_nn_launch_config(
        net_id(net), _DTYPES[dtype], m, out), "K7 launch config")
    return dict(zip(_LAUNCH, out))


def _check(net, q, arm_offset, obs, obs_div, cols, offset) -> int:
    """Raise unless the kernel takes these arguments; the network id."""
    nid = net_id(net)
    if q.device.type != "cuda":
        raise ValueError(f"forward_jacobian: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"forward_jacobian: float32 or float64, got "
                         f"{q.dtype}")
    w = net.layers[0].weight
    n_in = w.shape[1] // 3
    if q.dim() != 2 or q.stride(1) != 1 or q.shape[1] < arm_offset + ARM \
            or arm_offset < 0 or w.dtype != q.dtype or w.device != q.device:
        raise ValueError(
            f"forward_jacobian: q (M, >= {arm_offset + ARM}) with contiguous "
            f"rows, and the network, in one dtype on one device; got q "
            f"{tuple(q.shape)} {q.dtype} on {q.device}, the network "
            f"{w.dtype} on {w.device}")
    m = q.shape[0]
    if (obs is None) != (n_in == ARM):
        raise ValueError(f"forward_jacobian: the network takes {n_in} "
                         f"inputs: obs {'given' if obs is not None else 'missing'}")
    if obs is not None and (
            obs.dim() != 2 or obs.shape[1] != 3 or not obs.is_contiguous()
            or obs.dtype != q.dtype or obs.device != q.device
            or obs_div < 1 or obs.shape[0] * obs_div < m):
        raise ValueError(
            f"forward_jacobian: obs (rows, 3) contiguous in q's dtype on its "
            f"device, a row per {obs_div} of q's {m}; got "
            f"{tuple(obs.shape)} {obs.dtype} on {obs.device}")
    if not 0 < cols <= n_in or offset < 0:
        raise ValueError(f"forward_jacobian: cols {cols} of the {n_in} "
                         f"inputs, offset {offset}")
    return nid


def forward_jacobian(net: cnn.CollisionMLP, q: torch.Tensor,
                     arm_offset: int = 0, obs=None, obs_div: int = 1, *,
                     cols: int, offset: int = 0, mm_dtype=None,
                     interpret: bool | None = None, count: bool = False):
    """K7 on CUDA (q (M, dof), the arm's joints from column
    ``arm_offset``; obs (rows, 3) for the env network, a row for
    every ``obs_div`` rows of q; the network's weights on q's
    device in its dtype, float32 or float64); plain on CPU and under
    ``mm_dtype="bfloat16"``.  ``interpret`` names the route
    (`cuda_build.kernel_route`): ``True`` runs the plain version on either
    device, ``False`` the kernel only.  Returns ``(y (M, L), jac (M, L,
    offset + cols), counts (M,) int32 or None)``."""
    route = cuda_build.kernel_route(interpret, q.device, "forward_jacobian")
    if route == "plain" or mm_dtype is not None:
        return forward_jacobian_plain(net, q, arm_offset, obs, obs_div,
                                      cols=cols, offset=offset,
                                      mm_dtype=mm_dtype, count=count)
    # callers may pass views: the kernel reads rows of unit stride
    if q.dim() == 2 and q.stride(1) != 1:
        q = q.contiguous()
    if obs is not None:
        obs = obs.contiguous()
    nid = _check(net, q, arm_offset, obs, obs_div, cols, offset)
    weights = pack(net)
    _layout_matches(net, q.dtype)
    m = q.shape[0]
    n_out = net.layers[-1].out_features
    width = offset + cols
    y = torch.empty(m, n_out, dtype=q.dtype, device=q.device)
    jac = torch.empty(m, n_out, width, dtype=q.dtype, device=q.device)
    counts = (torch.empty(m, dtype=torch.int32, device=q.device) if count
              else None)
    parts, blocked, tree = out_order(m)
    forward_jacobian.launches += 1
    err = cuda_build.library().mpcc_collision_nn(
        nid, _DTYPES[q.dtype], weights.data_ptr(), q.data_ptr(), q.stride(0),
        arm_offset, obs.data_ptr() if obs is not None else None, obs_div, m,
        y.data_ptr(), jac.data_ptr(), n_out * width, width, offset, cols,
        counts.data_ptr() if counts is not None else None, parts, blocked,
        tree, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "K7 collision network kernel")
    return y, jac, counts


forward_jacobian.launches = 0


def _layout_matches(net, dtype) -> None:
    """Raise unless the kernel reads the pack as :func:`pack` lays it out
    (asked of the library once a network and dtype)."""
    key = (net_id(net), dtype)
    if key in _LAYOUT_SEEN:
        return
    want = pack_layout(net, dtype)
    got = layout(net, dtype)
    if any(got[k] != v for k, v in want.items()):
        raise RuntimeError(f"K7: the kernel's layout {got} is not the "
                           f"pack's {want}")
    _LAYOUT_SEEN.add(key)


_LAYOUT_SEEN: set = set()
