"""Gossip-SGD: the paper's protocol as a training primitive.

Counterpart of ``repro/core/gossip_optimizer.py``. Each data-parallel
replica is a *peer* holding its own (divergent) copy of the model. Instead
of all-reducing gradients every step, a peer takes a local optimizer step
and **averages parameters with one partner** chosen by a time-varying
permutation — CREATEMODELMU/UM (Algorithm 2) with a deterministic
peer-sampling schedule:

  MU:  params <- update( merge(params, partner(params)) )   (merge, then step)
  UM:  params <- merge( update(params), update(partner) )   (step, then merge)
  RW:  no merge (independent local SGD — the paper's baseline)

The peers' parameters are stacked on a leading 'peers' dim in one process
on one device (the reference's single-device path); the merge is a gather
of the partner's rows. The loss of each peer is that peer's own: the step
runs the loss and its backward once a peer, on that peer's slice of the
stacked parameters, so each slice of the stacked gradient is that peer's
gradient (the reference vmaps ``value_and_grad`` over the peer axis).

The quantized exchange (``exchange_dtype`` a codec name) encodes each
leaf's rows over its last axis with send kernels #2 (affine int8) and #4
(packed int4/ternary) through ``kernels.gossip_cycle.quantize_send`` — on
the CPU its plain version — and decodes with the codec's ``decode``. A row
is encoded where it lives, then the codes and scales travel to the partner:
encoding is row-local, so this gives the bits of the reference's encode of
the gathered partner rows.

The peer mesh (``mesh=`` a ``DeviceMesh``, ``peer_axes=``): the peers are
ranks, one peer a rank, and each rank holds its own peer's parameters,
optimizer state and batch, with no peer dim (``sharding.compat``: the
body runs once per rank). The exchange is a collective permute over the
peer axes (one or two, flattened in the order given, as JAX flattens a
tuple of axis names): on a quantized exchange a rank encodes its own rows
with the send kernels, permutes the codes with their scale (and
zero-point), and decodes what arrives. ``linear_gossip_mesh_step`` is the
paper's cycle with peers = ranks.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import GossipConfig
from repro_torch.core.peer_sampling import partner_schedule
from repro_torch.core.wire_codec import deterministic_codec, get_codec
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding import compat
from repro_torch.utils.tree import tree_leaves, tree_map


class GossipState(NamedTuple):
    params: dict            # per-peer stacked params (peers, ...)
    opt_state: dict         # per-peer stacked optimizer state
    step: torch.Tensor      # () int32


def _resolve_exchange(exchange_dtype):
    """Normalize ``gossip_merge``'s ``exchange_dtype``: a wire-codec name
    ("bf16", "int8", "int4_ef", ...), a torch dtype (the legacy spelling:
    16-bit floats cast, ``torch.int8`` = the "int8" codec), or None.
    Returns ``(codec, cast_dtype)``, at most one of them not None: the
    codec for the scale-carrying codecs (always the deterministic sibling:
    a train step threads no key), the dtype for plain float casts."""
    if exchange_dtype is None:
        return None, None
    if isinstance(exchange_dtype, str):
        codec = deterministic_codec(get_codec(exchange_dtype))
        if codec.quantized:
            return codec, None
        if codec.name == "f32":
            return None, None
        return None, codec.payload_dtype
    if not isinstance(exchange_dtype, torch.dtype):
        raise TypeError(f"exchange_dtype must be a codec name or a torch "
                        f"dtype, got {exchange_dtype!r}")
    if exchange_dtype == torch.int8:
        return get_codec("int8"), None
    return None, exchange_dtype


def stack_for_peers(params, n_peers: int):
    """Replicate params onto the peer axis: (…)-tree -> (peers, …)-tree of
    new contiguous tensors."""
    return tree_map(lambda p: p.detach().unsqueeze(0).expand(
        (n_peers,) + tuple(p.shape)).contiguous(), params)


@torch.no_grad()
def unstack_mean(params):
    """Consensus model: the float32 average over the peer axis (what the
    paper's nodes would each converge to; used for eval and checkpoints)."""
    return tree_map(lambda p: torch.mean(p.float(), dim=0), params)


def _encode_rows(p, codec, d: int):
    """Leaf ``p``'s rows of width ``d`` encoded by the send kernel (its
    plain version on the CPU): ``[payload, scale, zp or None]``."""
    from repro_torch.kernels.gossip_cycle import quantize_send

    rows = p.reshape(-1, d).to(torch.float32).contiguous()
    enc = quantize_send(rows, codec.name)
    return [enc[0], enc[1], enc[2] if codec.has_zp else None]


def _exchange(p, perm_t, codec):
    """The partner's rows of leaf ``p`` as they arrive through ``codec``,
    float32: every row over the last axis (a trailing axis of one for a
    rank-1 leaf, so no scale is shared across peers) encoded where it
    lives, codes and scales gathered by peer, then decoded."""
    d = p.shape[-1] if p.ndim >= 2 else 1
    n = p.shape[0]

    def take(a):
        return a.reshape((n, -1) + tuple(a.shape[1:]))[perm_t].reshape(
            a.shape)
    payload, scale, zp = (None if a is None else take(a)
                          for a in _encode_rows(p, codec, d))
    return codec.decode(payload, scale, zp, d).reshape(p.shape)


def _peer_axis(mesh, peer_axes, n_perm: int):
    """The :class:`compat.Axis` of the peer axes when the exchange runs
    between ranks, or None where the reference falls back to the stacked
    take (no mesh or no peer axes, a peer axis of size 1, or one whose
    size is not the permutation's length)."""
    if mesh is None or not peer_axes:
        return None
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    psz = int(np.prod([sizes[a] for a in peer_axes]))
    if psz == 1 or psz != n_perm:
        return None
    return compat.mesh_axis(mesh, tuple(peer_axes))


def _whole_rows(x):
    """A DTensor leaf resharded so that its local shard holds whole rows
    of its last axis (which the codecs encode a row at a time): a shard
    of the last axis moves to the first where the first divides, else it
    is gathered. Returns (the leaf, its placements before)."""
    from torch.distributed.tensor import Replicate, Shard
    before = list(x.placements)
    last = x.ndim - 1
    mesh = x.device_mesh
    want = list(before)
    for m, p in enumerate(before):
        if p.is_partial():
            want[m] = Replicate()
        if not p.is_shard(last):
            continue
        lead_free = last > 0 and not any(q.is_shard(0) for q in want)
        want[m] = (Shard(0) if lead_free and x.shape[0] % mesh.size(m) == 0
                   else Replicate())
    if want != before:
        x = x.redistribute(mesh, want)
    return x, before


def _merge_on_ranks(params, pairs, axis, codec, cast_dtype):
    """The merge of a rank's own peer (no peer dim) with the partner
    whose rows arrive over ``axis``. A DTensor leaf (a peer held
    tensor-parallel over the ranks of a peer's other mesh axes) is merged
    shard by shard: the partner of the same model shard sends its local
    rows, each whole (:func:`_whole_rows`), so a quantized row is encoded
    with the scale of the whole row, as on one device."""
    from repro_torch.sharding.act import from_block, is_dtensor

    def avg_leaf(x):
        if not is_dtensor(x):
            return avg(x)
        rows, before = _whole_rows(x)
        out = from_block(avg(rows.to_local()), rows.device_mesh,
                         rows.placements, rows.shape)
        if list(out.placements) != before:
            out = out.redistribute(out.device_mesh, before)
        return out

    def avg(x):
        if codec is not None:
            # encode this rank's rows, permute the codes with their scale
            # (and zero-point), decode on arrival; a scalar leaf gains a
            # trailing axis of one, as the stacked path's rank-1 leaf does
            d = x.shape[-1] if x.ndim >= 1 else 1
            parts = [None if a is None else compat.ppermute(a, pairs, axis)
                     for a in _encode_rows(x, codec, d)]
            xin = codec.decode(*parts, d).reshape(x.shape)
        elif cast_dtype is None or x.dtype == cast_dtype:
            xin = compat.ppermute(x, pairs, axis)
        else:
            # a float cast travels as its bits
            xin = compat.ppermute(x.to(cast_dtype), pairs, axis)
        return ((x.to(torch.float32) + xin.to(torch.float32)) / 2.0).to(
            x.dtype)
    return tree_map(avg_leaf, params)


@torch.no_grad()
def gossip_merge(params, perm, *, mesh=None, peer_axes: Tuple[str, ...] = (),
                 exchange_dtype=None):
    """MERGE with the partner given by ``perm`` (symmetric pairing):
    w_i <- (w_i + w_perm[i]) / 2, leaf by leaf, the average in float32 and
    cast back to the leaf's dtype. Returns a new tree.

    ``exchange_dtype``: the wire representation of the exchanged model
    (see ``_resolve_exchange``). The quantized codecs round-trip the
    partner's rows through the codec (send kernels #2 and #4 on CUDA
    tensors; one launch a leaf) before the float32 average; the ``_ef``
    codecs quantize one-shot (error feedback is a sender's state in the
    protocol engines, not in this stateless merge), and ``int8_sr`` rounds
    to nearest.

    With ``mesh`` and ``peer_axes`` whose size is ``len(perm)`` (> 1), the
    peers are ranks: ``params`` is this rank's peer, with no peer dim, and
    the partner's rows arrive by a collective permute over the peer axes
    (the quantized codes encoded where they live, with their scale and
    zero-point). Otherwise (the reference's fallback: a peer axis of size
    1 or of another size than ``perm``) ``params`` is the whole stack on
    every rank and the merge is the stacked take."""
    perm = np.asarray(perm)
    codec, cast_dtype = _resolve_exchange(exchange_dtype)
    axis = _peer_axis(mesh, peer_axes, len(perm))
    if axis is not None:
        pairs = [(s, int(perm[s])) for s in range(len(perm))]
        return _merge_on_ranks(params, pairs, axis, codec, cast_dtype)
    perm_on = {}                  # the permutation on each leaf's device

    def avg_take(p):
        if p.device not in perm_on:
            perm_on[p.device] = torch.as_tensor(perm, dtype=torch.int64,
                                                 device=p.device)
        perm_t = perm_on[p.device]
        if codec is not None:
            partner = _exchange(p, perm_t, codec)
        else:
            partner = p[perm_t]
            if cast_dtype is not None:
                partner = partner.to(cast_dtype)
            partner = partner.to(torch.float32)
        return ((p.to(torch.float32) + partner) / 2.0).to(p.dtype)

    return tree_map(avg_take, params)


@torch.no_grad()
def peer_disagreement(params) -> torch.Tensor:
    """Mean relative L2 distance of each peer from the consensus — the
    model-similarity diagnostic of the paper's Fig. 2, for trees. Summed
    a peer at a time, so a leaf's float32 temporaries are one peer's."""
    mean = unstack_mean(params)
    num = 0
    den = 0
    for p, m in zip(tree_leaves(params), tree_leaves(mean)):
        num = num + sum(torch.sum(torch.square(p[i].float() - m))
                        for i in range(p.shape[0]))
        den = den + p.shape[0] * torch.sum(torch.square(m))
    return torch.sqrt(num / torch.clamp(torch.as_tensor(den), min=1e-12))


def _value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch)``'s value, metrics and gradient with
    respect to every leaf of ``params`` (zeros where a leaf is unused)."""
    leaves_in = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves_in, batch)
        flat = tree_leaves(leaves_in)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else _like(g, x)
             for x, g in zip(flat, grads)]
    metrics = tree_map(lambda m: m.detach(), metrics)
    return loss.detach(), metrics, grads


def _like(g, x):
    """A DTensor gradient at its parameter's placements: a per-rank body
    leaves the gradient of a leaf it took whole as each rank's ``Partial``
    share (``sharding.act.body_input``), summed here once."""
    from repro_torch.sharding.act import is_dtensor
    if is_dtensor(g) and tuple(g.placements) != tuple(x.placements):
        return g.redistribute(x.device_mesh, x.placements)
    return g


def _plain(x):
    """A DTensor's whole value as a plain tensor; a tensor as it is."""
    from repro_torch.sharding.act import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def make_gossip_train_step(loss_fn: Callable, opt: Optimizer, n_peers: int,
                           cfg: GossipConfig, *,
                           spmd_axis: Optional[str] = None, mesh=None,
                           peer_axes: Tuple[str, ...] = ()):
    """Build the gossip training step.

    ``loss_fn(params, batch) -> (loss, metrics)`` for ONE peer; the step
    takes stacked params (peers, …) and batch (peers, per_peer, …) and a
    partner permutation ``perm`` (and ``pod_perm`` for the cross-pod
    merge, or None), from :func:`perms_for_step`. It returns the new state,
    the loss averaged over the peers and each metric stacked by peer. The
    optimizer updates in place, so the step may write into the state it is
    given: use only the state it returns.

    With ``mesh`` and ``peer_axes`` (or ``spmd_axis``, the one peer axis,
    as in the reference) of ``n_peers`` ranks (> 1), the peers are ranks:
    the state and the batch are this rank's peer's, with no peer dim, the
    merges permute over the peer axes (:func:`gossip_merge`), the
    global-norm clip sums every peer's squares (a ``psum`` before the
    scale, as the stacked step's norm spans the peers), the loss is the
    peers' mean and the metrics are this rank's."""
    peer_axes = tuple(peer_axes) or ((spmd_axis,) if spmd_axis and mesh
                                     is not None else ())
    axis = _peer_axis(mesh, peer_axes, n_peers)
    merge_kw = dict(exchange_dtype=cfg.exchange_dtype or None)

    if axis is not None:                # one peer a rank
        merge_kw.update(mesh=mesh, peer_axes=peer_axes)
        reduce_sq = lambda sq: compat.psum(_plain(sq), axis)  # noqa: E731

        def local_update(params, opt_state, batch, step):
            loss, metrics, g = _value_and_grad(loss_fn, params, batch)
            it = iter(g)
            grads = tree_map(lambda p: next(it), params)
            new_params, new_opt = opt.update(grads, opt_state, params, step,
                                             reduce_sq=reduce_sq)
            return (new_params, new_opt,
                    compat.psum(_plain(loss), axis) / n_peers, metrics)
    else:                               # the peers stacked

        def local_update(params, opt_state, batch, step):
            grads = tree_map(torch.empty_like, params)
            gleaves = tree_leaves(grads)
            losses, metrics = [], []
            for i in range(n_peers):
                loss, m, g = _value_and_grad(
                    loss_fn, tree_map(lambda p: p[i], params),
                    tree_map(lambda x: x[i], batch))
                with torch.no_grad():
                    for dst, src in zip(gleaves, g):
                        dst[i].copy_(src)
                del g
                losses.append(loss)
                metrics.append(m)
            new_params, new_opt = opt.update(grads, opt_state, params, step)
            metrics = tree_map(lambda *xs: torch.stack(xs), *metrics)
            return new_params, new_opt, torch.stack(losses).mean(), metrics

    def train_step(state: GossipState, batch, perm, pod_perm=None):
        params, opt_state = state.params, state.opt_state
        if cfg.merge == "mu":
            params = gossip_merge(params, perm, **merge_kw)
        params, opt_state, loss, metrics = local_update(
            params, opt_state, batch, state.step)
        if cfg.merge == "um":
            params = gossip_merge(params, perm, **merge_kw)
        if pod_perm is not None:
            params = gossip_merge(params, pod_perm, **merge_kw)
        return GossipState(params, opt_state, state.step + 1), loss, metrics

    return train_step


def make_allreduce_train_step(loss_fn: Callable, opt: Optimizer):
    """Baseline: conventional data parallelism. Params carry NO peer dim
    and the batch keeps its global leading dim; on one device the
    gradient all-reduce is the gradient of the whole batch. The optimizer
    updates in place (see :func:`make_gossip_train_step`)."""
    def train_step(params, opt_state, batch, step):
        loss, metrics, g = _value_and_grad(loss_fn, params, batch)
        it = iter(g)
        grads = tree_map(lambda p: next(it), params)
        new_params, new_opt = opt.update(grads, opt_state, params, step)
        return new_params, new_opt, loss, metrics

    return train_step


def perms_for_step(cfg: GossipConfig, step: int, n_peers: int,
                   n_pods: int = 1) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Host-side partner permutations for a given step (passed as args)."""
    perm = partner_schedule(cfg.schedule, step, n_peers, cfg.seed)
    pod_perm = None
    if n_pods > 1 and cfg.pod_every > 0 and (step + 1) % cfg.pod_every == 0:
        # pair each peer with the same peer index in the partner pod:
        # global peer id = pod * peers_per_pod + local
        per_pod = n_peers // n_pods
        pods = partner_schedule("hypercube", step // cfg.pod_every, n_pods,
                                cfg.seed)
        pod_perm = np.concatenate([pods[p] * per_pod + np.arange(per_pod)
                                   for p in range(n_pods)])
    return perm, pod_perm


@torch.no_grad()
def linear_gossip_mesh_step(w, t, X_local, y_local, perm, *, lam: float,
                            variant: str, axis: str = "data",
                            drop_mask=None, mesh=None):
    """One gossip cycle with peers = ranks (the reference's ``shard_map``
    runtime for the paper's linear models), run by every rank of the peer
    axis on its own peer.

    w: (d,) this rank's model, t: () int32 counter, ``(X_local,
    y_local)``: this peer's data (the fully distributed limit is one
    record). ``perm``: the ``(src, dst)`` pairs of the permute over
    ``mesh``'s axis ``axis`` (over the whole process group when ``mesh``
    is None). ``drop_mask`` (this rank's bool) drops the arriving message,
    the paper's message-drop failure. MU merges then takes a Pegasos step
    on record ``t mod len(X_local)``, UM steps then merges, RW only steps.
    Returns the new ``(w, t)``."""
    from repro_torch.core.learners import LinearModel, pegasos_update

    ax = compat.mesh_axis(mesh, (axis,) if mesh is not None else ())

    def merge_with_partner(w, t):
        w_in = compat.ppermute(w, perm, ax)
        t_in = compat.ppermute(t, perm, ax)
        if drop_mask is not None:
            keep = torch.as_tensor(drop_mask, device=w.device)
            w_in = torch.where(keep, w, w_in)
            t_in = torch.where(keep, t, t_in)
        return (w + w_in) / 2.0, torch.maximum(t, t_in)

    def update(w, t):
        i = t % X_local.shape[0]
        m = pegasos_update(LinearModel(w, t), X_local[i], y_local[i], lam)
        return m.w, m.t

    if variant == "mu":
        w, t = update(*merge_with_partner(w, t))
    elif variant == "um":
        w, t = merge_with_partner(*update(w, t))
    else:  # rw
        w, t = update(w, t)
    return w, t
