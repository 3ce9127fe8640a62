"""The device aggregation plane on ``torch.distributed`` (the port of
``photon_tpu/parallel/collective_agg.py``).

Clients that each train on a device of their own aggregate where their
deltas already are: a weighted average over a ``(clients, replica)``
mesh, the server optimizer applied on the device, no object store.

**The mesh.** A JAX mesh is a grid of devices one SPMD program spans.
Here a :class:`ClientMesh` is a ``(clients, replica)`` grid of
``torch.device`` entries plus the process group that joins the processes
owning its rows. A client's ``replica`` entries always belong to the
process that owns the client, so the intra-slice legs are tensor ops on
that process's devices (chunk selection before the exchange, the gather
after the update), and only the cross-client leg is a collective:

1. **Flat fp32 sum** (:func:`collective_weighted_average`): one weighted
   sum per leaf. Every program below reproduces it bit for bit at
   ``replica=1`` / ``quantization="off"``.
2. **Hierarchical** (:func:`hierarchical_weighted_average`): each client's
   contribution is split into ``replica`` chunks (the reduce-scatter
   layout of :func:`_chunk_len`); the cross-client sum runs per chunk and
   the chunks are gathered back. The sums are elementwise, so the result
   equals the flat one.
3. **q8 cross-client leg** (``quantization="q8"``): each client's chunk
   crosses as blockwise-int8 codes and fp32 per-block scales
   (:mod:`~photon_tpu_torch.compression.quantize_torch`, byte-identical
   to the host codec); every process gathers all clients' codes and scales
   and dequant-accumulates them in client order. Per element the average
   errs by at most ``Σ_c scale_c/2`` with ``scale_c = absmax(block of
   w_c·x_c)/127``; the modeled cross-client bytes drop 4 / (1 + 4/256)
   at the default block of 256.

The cross-client leg runs in two steps: a fixed-order sum over the
process's own rows, then one collective on the group for all leaves at
once (``all_reduce`` for ``off``; for ``q8`` an ``all_gather`` of codes
and one of scales). A single process needs no collective. The group's
backend is NCCL when every process drives a card of its own and gloo
otherwise (the CPU, or processes sharing one card: NCCL refuses two ranks
on one GPU); on gloo a CUDA tensor crosses through pinned host memory,
and :attr:`ClientMesh.staged_legs` names the legs that did.

A mesh may name one device more than once: on the CPU every entry is
``cpu`` (JAX's fake CPU devices share one host the same way), and on a
card an explicit mesh may repeat ``cuda:0``.

On top rides :class:`DeviceAggregationPlane`: average → pseudo-gradient →
FedAvgEff/Nesterov/FedMom/FedAdam/FedYogi update on the device, the
optimizer state living there between rounds, replicated or ZeRO-1
sharded over the replica ranks. ``strategy/optimizers.py`` stays the host
oracle: the device rules are the same operations in the same order, so a
round equals the host strategy's given the same average, bit for bit.
Every division divides by a tensor on the operand's device: PyTorch turns
a CUDA tensor's division by a Python scalar into a multiply by its
reciprocal, which rounds differently.

Torch does not retrace, so nothing here caches programs.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from photon_tpu_torch.compression.quantize import COLLECTIVE_QUANTIZATIONS, DEFAULT_BLOCK
from photon_tpu_torch.compression.quantize_torch import quantize_q8_torch

CLIENT_AXIS = "clients"
REPLICA_AXIS = "replica"


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


class ClientMesh:
    """A ``(clients, replica)`` grid of devices and the process group that
    joins the processes owning its rows.

    ``owners[c]`` is the rank of the process that owns row ``c``; entries
    of rows another process owns are never touched here (they may be
    ``None``). ``group`` is ``None`` when one process owns every row.
    """

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 owners: Sequence[int] | None = None, group=None, rank: int = 0,
                 backend: str | None = None) -> None:
        self.devices = devices
        self.axis_names = axis_names
        n = devices.shape[0]
        self.owners = tuple(int(o) for o in owners) if owners is not None else (rank,) * n
        if len(self.owners) != n:
            raise ValueError(f"{len(self.owners)} owners for {n} client rows")
        self.rank = int(rank)
        self.processes = sorted(set(self.owners))
        #: the group over ``processes`` (bound by the caller, possibly
        #: later: a group build is itself a collective among them)
        self.group = group if len(self.processes) > 1 else None
        self.backend = backend
        self.local_rows = [c for c, o in enumerate(self.owners) if o == self.rank]
        #: the legs ("n_total", "all_reduce", "all_gather") that crossed
        #: through host memory because the backend took no CUDA tensor
        self.staged_legs: set[str] = set()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def grid(self) -> np.ndarray:
        return self.devices if self.devices.ndim == 2 else self.devices[:, None]

    def device(self, replica_rank: int = 0) -> torch.device:
        """The device that holds this process's copy of replica rank
        ``replica_rank``'s chunk: the entry of its first row."""
        if not self.local_rows:
            raise ValueError(f"process {self.rank} owns no row of this mesh")
        return torch.device(self.grid[self.local_rows[0], replica_rank])

    def close(self) -> None:
        """Release the group (a mesh evicted from a cohort cache; the group
        of a failed attempt was taken off the mesh before)."""
        if self.group is not None:
            import torch.distributed as dist

            try:
                dist.destroy_process_group(self.group)
            except (RuntimeError, ValueError):  # a torn group has nothing to release
                pass
        self.group = None


def local_devices(device: str, need: int) -> list[torch.device]:
    """``need`` device slots of kind ``device``: ``cpu`` repeats the host
    (as JAX's fake CPU devices share it); ``cuda`` takes one card a slot
    and refuses, as JAX does, when there are fewer cards than slots."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * need
    have = torch.cuda.device_count()
    if have < need:
        raise ValueError(f"need {need} devices for the client mesh, have {have}")
    return [torch.device(kind, i) for i in range(need)]


def make_client_mesh(n_clients: int, devices: Sequence | None = None,
                     device: str = "cuda", **group_kw) -> ClientMesh:
    """1-D mesh with one entry per client (``devices`` explicit, or
    ``n_clients`` slots of ``device``)."""
    devices = list(devices) if devices is not None else local_devices(device, n_clients)
    if len(devices) < n_clients:
        raise ValueError(f"need {n_clients} devices for the client axis, have {len(devices)}")
    grid = np.empty(n_clients, dtype=object)
    grid[:] = [torch.device(d) if d is not None else None for d in devices[:n_clients]]
    return ClientMesh(grid, (CLIENT_AXIS,), **group_kw)


def make_hierarchical_mesh(n_clients: int, replica: int = 1, devices: Sequence | None = None,
                           device: str = "cuda", **group_kw) -> ClientMesh:
    """2-D ``(clients, replica)`` mesh: row ``c`` holds client ``c``'s
    ``replica`` devices, all on the process that owns the client
    (``owners``/``group``/``rank`` keywords: :class:`ClientMesh`).
    ``replica=1`` is the flat topology."""
    if replica < 1:
        raise ValueError(f"replica must be >= 1, got {replica}")
    need = n_clients * replica
    devices = list(devices) if devices is not None else local_devices(device, need)
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for a ({n_clients}, {replica}) client mesh, "
            f"have {len(devices)}"
        )
    grid = np.empty((n_clients, replica), dtype=object)
    flat = [torch.device(d) if d is not None else None for d in devices[:need]]
    for c in range(n_clients):
        for r in range(replica):
            grid[c, r] = flat[c * replica + r]
    return ClientMesh(grid, (CLIENT_AXIS, REPLICA_AXIS), **group_kw)


def mesh_replica(mesh: ClientMesh) -> int:
    """Replica width of a client mesh (1 on the flat 1-D topology)."""
    return int(mesh.shape[REPLICA_AXIS]) if REPLICA_AXIS in mesh.axis_names else 1


def group_backend(local_device: torch.device, group=None) -> str:
    """``nccl`` when every process of ``group`` (the default group when
    ``None``) drives a CUDA card no other process of it drives, ``gloo``
    otherwise. A collective over the group: every member calls it."""
    import socket

    import torch.distributed as dist

    dev = torch.device(local_device)
    index = dev.index if dev.index is not None else (
        torch.cuda.current_device() if dev.type == "cuda" else 0)
    mine = (socket.gethostname(), dev.type, index)
    every: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, mine, group=group)
    if all(k[1] == "cuda" for k in every) and len(set(every)) == len(every):
        return "nccl"
    return "gloo"


# ---------------------------------------------------------------------------
# the cross-client leg
# ---------------------------------------------------------------------------


def _chunk_len(n: int, replica: int, quantization: str, block: int) -> int:
    """Per-rank chunk length of one flattened leaf under the reduce-scatter
    layout: block-aligned on the q8 policy (the encode never sees a ragged
    tail inside the exchange), plain ceil-division otherwise. The same
    function sizes the ZeRO-1 state, so the state shards line up with the
    reduced chunks by construction; block boundaries stay aligned to the
    global padded vector for every ``replica``, so the q8 scales (and the
    averages) are the same bits across a resharding."""
    if quantization == "q8":
        return -(-n // (replica * block)) * block
    return -(-n // replica)


def _check_args(quantization: str, block: int) -> None:
    if quantization not in COLLECTIVE_QUANTIZATIONS:
        raise ValueError(
            f"quantization must be one of {COLLECTIVE_QUANTIZATIONS}, got "
            f"{quantization!r}"
        )
    if block < 1:
        # callers resolve the config's 0-means-default before here
        raise ValueError(f"block must be >= 1, got {block}")


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``like``'s device (a divisor that
    keeps true division on a CUDA tensor)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _staged(mesh: ClientMesh, leg: str, t: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The tensor a collective gets: ``t`` itself, or a pinned host copy
    when the group's backend takes no CUDA tensor."""
    if t.device.type == "cuda" and mesh.backend != "nccl":
        mesh.staged_legs.add(leg)
        return t.to("cpu", non_blocking=False).pin_memory(), True
    return t, False


def _group(mesh: ClientMesh):
    """The mesh's group, or None when one process owns every row."""
    if len(mesh.processes) == 1:
        return None
    if mesh.group is None:
        raise RuntimeError(
            f"the mesh's rows belong to processes {mesh.processes} but no "
            "process group is bound to it"
        )
    return mesh.group


def _all_reduce(mesh: ClientMesh, t: torch.Tensor, leg: str = "all_reduce") -> torch.Tensor:
    """The sum of ``t`` over the group's processes, in a new tensor (``t``
    may be a view of the caller's own: a lone local row's count)."""
    if _group(mesh) is None:
        return t
    import torch.distributed as dist

    buf, staged = _staged(mesh, leg, t)
    if not staged:
        buf = buf.clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.device) if staged else buf


def _all_gather_rows(mesh: ClientMesh, local: torch.Tensor) -> list[torch.Tensor]:
    """``local`` holds this process's rows ``[n_local, ...]`` (ascending);
    returns every client's row in global row order."""
    if _group(mesh) is None:
        return list(local.unbind(0))
    import torch.distributed as dist

    counts = [mesh.owners.count(p) for p in mesh.processes]
    width = max(counts)
    if local.shape[0] < width:  # equal sizes on the wire: pad with zero rows
        local = torch.cat([local, local.new_zeros((width - local.shape[0],) + local.shape[1:])])
    buf, staged = _staged(mesh, "all_gather", local.contiguous())
    parts = [torch.empty_like(buf) for _ in mesh.processes]
    dist.all_gather(parts, buf, group=mesh.group)
    taken = {p: 0 for p in mesh.processes}
    rows = []
    for owner in mesh.owners:
        part = parts[mesh.processes.index(owner)]
        rows.append(part[taken[owner]])
        taken[owner] += 1
    return [r.to(local.device) for r in rows] if staged else rows


def _local_sum(rows: list[torch.Tensor]) -> torch.Tensor:
    """Fixed-order sum of this process's rows (ascending row order)."""
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc


def _reduce_chunks(mesh: ClientMesh, contribs: list[list[torch.Tensor]],
                   quantization: str, block: int) -> list[list[torch.Tensor]]:
    """The cross-client reduction of weighted contributions, per replica
    rank. ``contribs[j][i]``: local row j's fp32 contribution to leaf i.
    Returns ``out[r][i]``: rank r's chunk of leaf i's sum over ALL clients,
    on :meth:`ClientMesh.device` ``(r)``."""
    replica = mesh_replica(mesh)
    n_leaves = len(contribs[0])
    out: list[list[torch.Tensor]] = []
    for r in range(replica):
        dev = mesh.device(r)
        chunks_by_row = []
        for row in contribs:
            cs = []
            for leaf in row:
                flat = leaf.reshape(-1)
                n = flat.numel()
                chunk = _chunk_len(n, replica, quantization, block)
                pad = replica * chunk - n
                start, stop = r * chunk, (r + 1) * chunk
                if pad and stop > n:
                    part = flat[start:n] if start < n else flat[:0]
                    part = torch.cat([part, part.new_zeros(stop - max(start, n))])
                else:
                    part = flat[start:stop]
                cs.append(part.to(dev))
            chunks_by_row.append(cs)
        sizes = [c.numel() for c in chunks_by_row[0]]
        if quantization == "q8":
            # each row's chunks cross as codes + scales, all leaves at once
            # (every chunk is block-aligned, so the scales stay per leaf)
            codes, scales = [], []
            for cs in chunks_by_row:
                c, s = quantize_q8_torch(torch.cat(cs), block)
                codes.append(c)
                scales.append(s)
            all_codes = _all_gather_rows(mesh, torch.stack(codes))
            all_scales = _all_gather_rows(mesh, torch.stack(scales))
            red = None
            for c, s in zip(all_codes, all_scales):  # client order
                term = (c.to(torch.float32).reshape(-1, block) * s[:, None]).reshape(-1)
                red = term if red is None else red + term
        else:
            red = _all_reduce(mesh, _local_sum([torch.cat(cs) for cs in chunks_by_row]))
        out.append(list(torch.split(red, sizes)) if n_leaves > 1 else [red])
    return out


def _gather_replicas(chunks: list[torch.Tensor], n: int, shape, device) -> torch.Tensor:
    """The replica ranks' chunks of one leaf → the full tensor on
    ``device`` (the intra-slice gather)."""
    if len(chunks) == 1:
        full = chunks[0].to(device)
    else:
        full = torch.cat([c.to(device) for c in chunks])
    return full[:n].reshape(shape)


def _as_rows(leaf) -> list[torch.Tensor]:
    if isinstance(leaf, torch.Tensor):
        return list(leaf.unbind(0))
    return [r if isinstance(r, torch.Tensor) else torch.as_tensor(np.asarray(r)) for r in leaf]


def _flatten(tree) -> tuple[list, Any]:
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], keys
    return list(tree), None


def _unflatten(leaves: list, keys):
    return dict(zip(keys, leaves)) if keys is not None else leaves


def _weights(mesh: ClientMesh, ns, n_local: int) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Per local row ``n_c / Σn`` in fp32 (Σn over ALL clients: one
    all_reduce), and Σn."""
    dev = mesh.device(0)
    ns = torch.as_tensor(np.asarray(ns.cpu() if isinstance(ns, torch.Tensor) else ns))
    if ns.numel() != n_local:
        raise ValueError(f"{ns.numel()} sample counts for {n_local} local rows")
    nf = ns.to(torch.float32).to(dev)
    total = _all_reduce(mesh, _local_sum(list(nf.unbind(0))), "n_total")
    return [nf[j] / total for j in range(n_local)], total


def _reduced(mesh: ClientMesh, leaves: list, ns, quantization: str, block: int):
    """This process's rows of each leaf, weighted by ``n_c / Σn`` and
    reduced over every client: ``(rows, chunks[r][i], Σn)``."""
    rows = [_as_rows(leaf) for leaf in leaves]
    n_local = len(rows[0]) if rows else 0
    if n_local != len(mesh.local_rows):
        raise ValueError(
            f"collective aggregation expects 1 row per owned client row, got "
            f"{n_local} rows for {len(mesh.local_rows)} — repack the client mesh"
        )
    w, total = _weights(mesh, ns, n_local)
    contribs = [[rows[i][j].to(w[j].device, torch.float32) * w[j] for i in range(len(leaves))]
                for j in range(n_local)]
    return rows, _reduce_chunks(mesh, contribs, quantization, block), total


def _average(mesh: ClientMesh, leaves: list, ns, quantization: str, block: int
             ) -> tuple[list[torch.Tensor], torch.Tensor]:
    rows, chunks, total = _reduced(mesh, leaves, ns, quantization, block)
    out = []
    for i, leaf_rows in enumerate(rows):
        shape = tuple(leaf_rows[0].shape)
        out.append(_gather_replicas([chunks[r][i] for r in range(len(chunks))],
                                    leaf_rows[0].numel(), shape, mesh.device(0)))
    return out, total


def hierarchical_weighted_average(stacked_params, n_samples, mesh: ClientMesh,
                                  quantization: str = "off", block: int = DEFAULT_BLOCK,
                                  return_total: bool = False):
    """Sample-weighted average over the client axis, hierarchical over the
    replica axis when the mesh has one, optionally int8-quantized on the
    cross-client leg.

    ``stacked_params``: a list (or dict) of leaves, each this process's
    rows ``[n_local, ...]`` (one tensor, or a list of per-row tensors) in
    ascending row order; ``n_samples``: their ``[n_local]`` counts or
    weights. Returns the averaged leaves (fp32, on
    :meth:`ClientMesh.device`), the same on every process; with
    ``return_total`` also Σn."""
    _check_args(quantization, block)
    leaves, keys = _flatten(stacked_params)
    avg, total = _average(mesh, leaves, n_samples, quantization, block)
    avg = _unflatten(avg, keys)
    return (avg, total) if return_total else avg


def grouped_weighted_average(stacked_flat: Sequence, n_samples, cohort_onehot,
                             mesh: ClientMesh, quantization: str = "off",
                             block: int = DEFAULT_BLOCK
                             ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Sample-weighted per-cohort averages over the client axis in one
    reduction: every client contributes its row weighted into its own
    cohort's slot of a ``[K, ...]`` stack, and one cross-client leg lands
    every cohort's mean (K cohorts cost one collective, not K).

    ``cohort_onehot``: ``[n_local, K]`` 0/1 rows (a client in no cohort is
    an all-zero row). Returns ``([K, ...] fp32 averaged leaves, the
    per-cohort Σn [K])``; a cohort whose total is 0 had no member and its
    slot is meaningless zeros: callers leave its state untouched."""
    _check_args(quantization, block)
    onehot = torch.as_tensor(np.asarray(
        cohort_onehot.cpu() if isinstance(cohort_onehot, torch.Tensor) else cohort_onehot),
        dtype=torch.float32)
    n_cohorts = int(onehot.shape[1])
    if n_cohorts < 1:
        raise ValueError("need at least one cohort column")
    rows = [_as_rows(leaf) for leaf in stacked_flat]
    n_local = len(rows[0])
    if n_local != len(mesh.local_rows):
        raise ValueError(
            f"collective aggregation expects 1 row per owned client row, got "
            f"{n_local} rows for {len(mesh.local_rows)} — repack the client mesh"
        )
    dev = mesh.device(0)
    ns = torch.as_tensor(np.asarray(
        n_samples.cpu() if isinstance(n_samples, torch.Tensor) else n_samples))
    nf = ns.to(torch.float32).to(dev)
    oh = onehot.to(dev)
    totals = _all_reduce(mesh, _local_sum([nf[j] * oh[j] for j in range(n_local)]), "n_total")
    denom = torch.maximum(totals, torch.ones_like(totals))
    contribs = []
    for j in range(n_local):
        w = oh[j] * (nf[j] / denom)  # [K] cohort weights
        row = []
        for i in range(len(rows)):
            x = rows[i][j].to(dev, torch.float32)
            row.append(w.reshape((n_cohorts,) + (1,) * x.dim()) * x[None])
        contribs.append(row)
    chunks = _reduce_chunks(mesh, contribs, quantization, block)
    out = []
    for i, leaf_rows in enumerate(rows):
        shape = (n_cohorts,) + tuple(leaf_rows[0].shape)
        out.append(_gather_replicas([chunks[r][i] for r in range(len(chunks))],
                                    n_cohorts * leaf_rows[0].numel(), shape, dev))
    return out, totals


def staleness_discount(staleness, policy: str = "poly", power: float = 1.0):
    """Staleness-discount multiplier d(s) for the async buffered server:
    ``poly`` → ``(1 + s)^(−power)`` (the FedAsync polynomial), ``const`` →
    1.0. Vectorized over numpy inputs; d(0) == 1.0 exactly under both
    policies (the zero-staleness bit-parity regime)."""
    s = np.asarray(staleness, np.float64)
    if np.any(s < 0):
        raise ValueError("staleness must be >= 0")
    if policy == "const":
        return np.ones_like(s)
    if policy == "poly":
        return (1.0 + s) ** (-float(power))
    raise ValueError(f"staleness_policy must be 'poly' or 'const', got {policy!r}")


def discounted_fold_weights(n_samples: Sequence[int], staleness: Sequence[int],
                            policy: str = "poly", power: float = 1.0) -> np.ndarray:
    """Per-client fold weights ``n_i · d(s_i)``. When every discount is
    exactly 1 (an all-fresh buffer, or the const policy) they come back
    int32, the synchronous round's counts, so an all-fresh async fold is
    bit for bit the sync round's; any real discount gives float32."""
    ns = np.asarray(n_samples)
    d = staleness_discount(staleness, policy, power)
    if np.all(d == 1.0):
        return ns.astype(np.int32)
    return (ns.astype(np.float64) * d).astype(np.float32)


def discounted_weighted_average(stacked_params, n_samples: Sequence[int],
                                staleness: Sequence[int], mesh: ClientMesh,
                                policy: str = "poly", power: float = 1.0,
                                quantization: str = "off", block: int = DEFAULT_BLOCK,
                                return_total: bool = False):
    """Staleness-discounted weighted average: :func:`hierarchical_weighted_average`
    with weights pre-scaled by d(staleness) on the host; the plain average
    at zero staleness, bit for bit. ``return_total`` gives Σ n·d."""
    w = discounted_fold_weights(n_samples, staleness, policy, power)
    return hierarchical_weighted_average(stacked_params, w, mesh, quantization=quantization,
                                         block=block, return_total=return_total)


def collective_weighted_average(stacked_params, n_samples, mesh: ClientMesh,
                                return_total: bool = False):
    """The flat fp32 average (``quantization="off"``); on a hierarchical
    mesh it runs the chunked reduce."""
    return hierarchical_weighted_average(stacked_params, n_samples, mesh, quantization="off",
                                         return_total=return_total)


def collective_fedavg_round(stacked_params, global_params, n_samples, mesh: ClientMesh,
                            server_lr: float = 1.0):
    """Stateless FedAvgEff round on the device: weighted average →
    pseudo-gradient → server SGD step (``x ← x − η(x − avg)``); exact
    FedAvg at ``server_lr=1``. Stateful server optimizers run through
    :class:`DeviceAggregationPlane`."""
    avg = collective_weighted_average(stacked_params, n_samples, mesh)
    g_leaves, keys = _flatten(global_params)
    a_leaves, _ = _flatten(avg)
    out = []
    for x, a in zip(g_leaves, a_leaves):
        x = torch.as_tensor(x)
        xf = x.to(a.device, torch.float32)
        out.append((xf - server_lr * (xf - a)).to(x.dtype))
    return _unflatten(out, keys)


def stack_for_clients(host_params_per_client: list, mesh: ClientMesh):
    """Host helper (tests, one process): this process's clients' trees
    (lists or dicts of arrays, one per client row) → stacked leaves on the
    rows' devices."""
    mine = [host_params_per_client[c] for c in mesh.local_rows]
    leaves_per, keys = zip(*(_flatten(t) for t in mine))
    stacked = [torch.stack([torch.as_tensor(np.asarray(leaves[i])) for leaves in leaves_per])
               .to(mesh.device(0)) for i in range(len(leaves_per[0]))]
    return _unflatten(stacked, keys[0])


# ---------------------------------------------------------------------------
# modeled cross-client bytes
# ---------------------------------------------------------------------------


def modeled_cross_slice_bytes(sizes: Sequence[int], n_clients: int, replica: int = 1,
                              quantization: str = "off", block: int = DEFAULT_BLOCK) -> int:
    """Idealized bytes crossing client boundaries in one aggregation round:
    every client's (padded) contribution crosses once, summed over
    clients. The fp32/q8 ratio is what the model is for. ``sizes`` are
    per-leaf element counts; ``replica`` splits the exchange across ranks
    without changing the total."""
    total = 0
    for n in sizes:
        n = int(n)
        if quantization == "q8":
            chunk = -(-n // (replica * block)) * block
            padded = replica * chunk
            total += padded + (padded // block) * 4
        else:
            total += -(-n // replica) * replica * 4
    return total * int(n_clients)


# ---------------------------------------------------------------------------
# device-resident server optimizers
# ---------------------------------------------------------------------------

#: strategy.name → state tensor lists the device plane carries (mirrors
#: ``strategy/optimizers.py`` ``state_keys``)
DEVICE_RULES: dict[str, tuple[str, ...]] = {
    "fedavg": (),
    "nesterov": ("momentum",),
    "fedmom": ("momentum",),
    "fedadam": ("momentum_1", "momentum_2"),
    "fedyogi": ("momentum_1", "momentum_2"),
}


def device_server_update(rule: str, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                         state: dict[str, Sequence[torch.Tensor]], lr: float,
                         b1t: float, b2t: float, momentum: float = 0.0,
                         beta_1: float = 0.9, beta_2: float = 0.99, tau: float = 1.0e-9
                         ) -> tuple[list[torch.Tensor], dict[str, list[torch.Tensor]]]:
    """The five host update rules in torch, operation for operation
    (``strategy/optimizers.py`` is the oracle). ``g`` is the
    pseudo-gradient ``x − avg``; ``b1t``/``b2t`` are the host-computed bias
    corrections ``1 − β^t``, divided by as fp32 tensors on the operands'
    device (numpy divides by them as fp32 too); the square root is the
    correctly rounded one (:func:`_sqrt`)."""
    if rule == "fedavg":
        return [x - lr * g for x, g in zip(params, grads)], {}
    if rule in ("nesterov", "fedmom"):
        new_m = [momentum * m + g for m, g in zip(state["momentum"], grads)]
        if rule == "nesterov":
            new_p = [x - lr * (g + momentum * m) for x, g, m in zip(params, grads, new_m)]
        else:
            new_p = [x - lr * m for x, m in zip(params, new_m)]
        return new_p, {"momentum": new_m}
    if rule not in ("fedadam", "fedyogi"):
        raise ValueError(f"no device update rule for strategy {rule!r}")
    new_m1 = [beta_1 * m + (1.0 - beta_1) * g for m, g in zip(state["momentum_1"], grads)]
    if rule == "fedadam":
        new_m2 = [beta_2 * v + (1.0 - beta_2) * torch.square(g)
                  for v, g in zip(state["momentum_2"], grads)]
    else:
        new_m2 = []
        for v, g in zip(state["momentum_2"], grads):
            g2 = torch.square(g)
            new_m2.append(v - (1.0 - beta_2) * g2 * torch.sign(v - g2))
    new_p = [x - lr * (m / _scalar(b1t, m)) / (_sqrt(v / _scalar(b2t, v)) + tau)
             for x, m, v in zip(params, new_m1, new_m2)]
    return new_p, {"momentum_1": new_m1, "momentum_2": new_m2}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root (``np.sqrt``'s): through
    fp64, exact for an fp32 input. torch's vectorized fp32 ``sqrt`` on the
    CPU can land one ulp off."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _sq(tensors: Sequence[torch.Tensor]) -> float:
    """Σ x² over fp32 tensors, summed in order (the host takes the sqrt)."""
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t))
        total = s if total is None else total + s
    return float(total) if total is not None else 0.0


class DeviceAggregationPlane:
    """The server round on the device: hierarchical (optionally q8)
    weighted average → pseudo-gradient → server optimizer update.

    **ZeRO-1 sharding** (``sharded=True``, the default): between rounds the
    parameters and optimizer moments live as padded-and-flattened fp32
    chunks, replica rank r holding chunk r of every leaf (the exact layout
    of :func:`_chunk_len`). The reduced chunk stays on its rank: the
    pseudo-gradient, all five rules, the q8 ``nonneg_rows`` clamp and the
    norms run per chunk, and only :meth:`params_host` gathers the updated
    parameters. Per-rank server memory and update work divide by
    ``replica``; the update is elementwise, so the sharded round equals the
    replicated one bit for bit, and checkpoints round-trip across a
    resharding. ``sharded=False`` keeps one full copy per process.

    A process keeps one copy of each rank's state, on its first row's
    devices (the rows it owns would hold the same values). The host
    :class:`~photon_tpu_torch.strategy.base.Strategy` supplies the rule and
    its hyperparameters and stays the checkpoint authority
    (:meth:`sync_strategy`, :meth:`reseed_from`).
    """

    def __init__(self, mesh: ClientMesh, strategy: Any, quantization: str = "off",
                 block: int = DEFAULT_BLOCK, nonneg_rows: Sequence[int] = (),
                 sharded: bool = True) -> None:
        if strategy.name not in DEVICE_RULES:
            raise ValueError(
                f"strategy {strategy.name!r} has no device update rule "
                f"(supported: {sorted(DEVICE_RULES)})"
            )
        if quantization not in COLLECTIVE_QUANTIZATIONS:
            raise ValueError(
                f"quantization must be one of {COLLECTIVE_QUANTIZATIONS}, "
                f"got {quantization!r}"
            )
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if strategy.current_parameters is None:
            raise RuntimeError("strategy not initialized with parameters")
        self.mesh = mesh
        self.rule = strategy.name
        self.quantization = quantization
        self.block = int(block)
        self.state_keys = tuple(strategy.state_keys)
        self.n_clients = int(mesh.shape[CLIENT_AXIS])
        self.hyper = {
            "momentum": float(strategy.momentum),
            "beta_1": float(getattr(strategy, "beta_1", 0.9)),
            "beta_2": float(getattr(strategy, "beta_2", 0.99)),
            "tau": float(getattr(strategy, "tau", 1.0e-9)),
        }
        self.adaptive = self.rule in ("fedadam", "fedyogi")
        #: server-update step counter (adaptive bias correction), seeded
        #: from a restored strategy so a resume keeps ``1 − β^t`` continuous
        self.t = int(getattr(strategy, "_t", 0))
        self.sharded = bool(sharded)
        self.replica = mesh_replica(mesh)
        self._shapes = [tuple(np.shape(p)) for p in strategy.current_parameters]
        self._sizes = [int(np.prod(s, dtype=np.int64)) for s in self._shapes]
        self._chunks = [_chunk_len(n, self.replica, quantization, int(block)) for n in self._sizes]
        #: wall seconds of the last post-update params gather + fetch
        #: (``server/opt_allgather_time``; 0 until the first params_host)
        self.last_allgather_s = 0.0
        n_rows = len(strategy.current_parameters)
        if any(not 0 <= int(i) < n_rows for i in nonneg_rows):
            raise ValueError(
                f"nonneg_rows out of range for a {n_rows}-row payload: "
                f"{sorted(int(i) for i in nonneg_rows)}"
            )
        #: payload rows that must stay >= 0 (aggregated second moments in a
        #: [params|m1|m2] payload), clamped on the q8 path only: at `off`
        #: an all-zero m2 element's pseudo-gradient is exactly zero, but q8
        #: noise makes it tiny-nonzero and the adaptive rules then step the
        #: element negative (the clients' sqrt(m2) NaNs). Clamping at `off`
        #: would break the bit-exact pins against the host oracle.
        self.nonneg_rows = tuple(sorted({int(i) for i in nonneg_rows}))
        # the abandon epoch: bumped when the caller gives up on an
        # in-flight run_round (a missed stage deadline), so a late run
        # cannot commit under the round that replaced it; the lock makes
        # check-and-commit atomic with abandon()/restore()/reseed_from()
        self._epoch = 0
        self._commit_lock = threading.Lock()
        self._seed_from_host(strategy)

    # -- layout ------------------------------------------------------------
    def _chunk_of(self, leaf: np.ndarray | None, i: int, r: int) -> torch.Tensor:
        """Replica rank ``r``'s chunk of leaf ``i`` (``None`` = zeros) on
        its device. A chunk inside the leaf is copied from a view of it; no
        padded host copy of the whole leaf is made."""
        n, chunk = self._sizes[i], self._chunks[i]
        dev = self.mesh.device(r)
        if leaf is None:
            return torch.zeros(chunk, dtype=torch.float32, device=dev)
        flat = np.asarray(leaf, np.float32).reshape(-1)
        start, stop = r * chunk, (r + 1) * chunk
        if stop <= n:
            return torch.from_numpy(flat[start:stop]).to(dev, copy=True)
        out = torch.zeros(chunk, dtype=torch.float32, device=dev)
        if start < n:
            out[: n - start] = torch.from_numpy(flat[start:n]).to(dev)
        return out

    def _full(self, leaf: np.ndarray | None, i: int) -> torch.Tensor:
        dev = self.mesh.device(0)
        if leaf is None:
            return torch.zeros(self._shapes[i], dtype=torch.float32, device=dev)
        return torch.from_numpy(np.asarray(leaf, np.float32)).to(dev, copy=True)

    def _seed_from_host(self, strategy: Any) -> None:
        """Put params and optimizer state from the host strategy on the
        device (shared by ``__init__`` and :meth:`reseed_from`); missing
        state keys seed zero-filled. On the sharded plane ``params[i]`` is
        a list of per-rank chunks."""
        host_state = {k: strategy.state.get(k) for k in self.state_keys}
        if self.sharded:
            self.params = [[self._chunk_of(p, i, r) for r in range(self.replica)]
                           for i, p in enumerate(strategy.current_parameters)]
            self.state = {
                k: [[self._chunk_of(h[i] if h is not None else None, i, r)
                     for r in range(self.replica)] for i in range(len(self._sizes))]
                for k, h in host_state.items()
            }
            return
        self.params = [self._full(p, i) for i, p in enumerate(strategy.current_parameters)]
        self.state = {k: [self._full(h[i] if h is not None else None, i)
                          for i in range(len(self._sizes))]
                      for k, h in host_state.items()}

    # -- the round ---------------------------------------------------------
    def current_epoch(self) -> int:
        """Abandon-epoch token for ``run_round(epoch=...)``, captured on
        the caller's thread before the stage worker starts (an abandon
        issued while the worker ramps up must not be missed)."""
        with self._commit_lock:
            return self._epoch

    def run_round(self, stacked_flat: Sequence, n_samples, lr: float,
                  epoch: int | None = None) -> dict[str, float]:
        """One server round over this process's stacked rows. Updates the
        device-resident params/state and returns the round metrics (the
        host ``Strategy.apply_average`` vocabulary). ``epoch``: the token
        from :meth:`current_epoch` when running on a deadline-abandonable
        worker."""
        from photon_tpu_torch.utils.profiling import (
            EFFECTIVE_LR,
            N_CLIENTS,
            N_SAMPLES,
            PARAM_NORM,
            PSEUDO_GRAD_NORM,
        )

        n_leaves = len(self._sizes)
        if len(stacked_flat) != n_leaves:
            raise ValueError(
                f"stacked payload has {len(stacked_flat)} arrays, plane holds "
                f"{n_leaves} (momenta mismatch? the server extends "
                "initial params with zero momenta when aggregate_momenta is on)"
            )
        if epoch is None:
            epoch = self.current_epoch()
        t_next = self.t + 1 if self.adaptive else self.t
        if self.adaptive:
            b1t = 1.0 - self.hyper["beta_1"] ** t_next
            b2t = 1.0 - self.hyper["beta_2"] ** t_next
        else:
            b1t = b2t = 1.0
        clamp = frozenset(self.nonneg_rows) if self.quantization == "q8" else frozenset()
        _, chunks, n_total = _reduced(self.mesh, list(stacked_flat), n_samples,
                                      self.quantization, self.block)
        if self.sharded:
            # the reduced chunk IS the rank's share of the average: no
            # gather before the update
            new_params = [[None] * self.replica for _ in range(n_leaves)]
            new_state = {k: [[None] * self.replica for _ in range(n_leaves)]
                         for k in self.state_keys}
            sq = {"pseudo_grad": 0.0, "param": 0.0, **{k: 0.0 for k in self.state_keys}}
            for r in range(self.replica):
                params = [self.params[i][r] for i in range(n_leaves)]
                grads = [x - a for x, a in zip(params, chunks[r])]
                state = {k: [self.state[k][i][r] for i in range(n_leaves)]
                         for k in self.state_keys}
                p_new, s_new = device_server_update(self.rule, params, grads, state, lr,
                                                    b1t, b2t, **self.hyper)
                for i in range(n_leaves):
                    p = p_new[i]
                    # padding stays exactly 0 under max(·, 0)
                    new_params[i][r] = torch.clamp_min(p, 0.0) if i in clamp else p
                    for k in self.state_keys:
                        new_state[k][i][r] = s_new[k][i]
                # per-shard partial squared sums, summed over the ranks in
                # order (padding contributes exact zeros)
                sq["pseudo_grad"] += _sq(grads)
                sq["param"] += _sq(params)
                for k in self.state_keys:
                    sq[k] += _sq(s_new[k])
        else:
            avgs = [_gather_replicas([chunks[r][i] for r in range(self.replica)],
                                     self._sizes[i], self._shapes[i], self.mesh.device(0))
                    for i in range(n_leaves)]
            grads = [x - a for x, a in zip(self.params, avgs)]
            p_new, s_new = device_server_update(self.rule, self.params, grads, self.state,
                                                lr, b1t, b2t, **self.hyper)
            new_params = [torch.clamp_min(p, 0.0) if i in clamp else p
                          for i, p in enumerate(p_new)]
            new_state = s_new
            # the param norm is over the PRE-update parameters, the state
            # norms over the post-update state: what the host oracle's
            # norm_telemetry sees inside apply_average
            sq = {"pseudo_grad": _sq(grads), "param": _sq(self.params)}
            for k in self.state_keys:
                sq[k] = _sq(new_state[k])
        metrics = {
            N_CLIENTS: float(self.n_clients),
            N_SAMPLES: float(n_total),
            EFFECTIVE_LR: float(lr),
            PSEUDO_GRAD_NORM: float(np.sqrt(sq["pseudo_grad"])),
            PARAM_NORM: float(np.sqrt(sq["param"])),
        }
        for k in self.state_keys:
            metrics[f"server/{k}_norm"] = float(np.sqrt(sq[k]))
        # the scalar reads above synchronized, so the round is complete:
        # only now commit it. A failed round leaves params/state/t as they
        # were; an abandoned one (the caller moved on) commits nothing.
        with self._commit_lock:
            if epoch == self._epoch:
                self.params = new_params
                self.state = new_state
                self.t = t_next
        return metrics

    def abandon(self) -> None:
        """Disown any in-flight :meth:`run_round`: its commit is skipped
        when it finishes. Returns once any commit already past its epoch
        check has finished its writes."""
        with self._commit_lock:
            self._epoch += 1

    def snapshot(self) -> tuple:
        """Commit-state snapshot (references: the round replaces tensors,
        it never writes them in place), taken before a collective attempt."""
        with self._commit_lock:
            return (list(self.params), {k: list(v) for k, v in self.state.items()}, self.t)

    def restore(self, snap: tuple) -> None:
        """Roll back to a :meth:`snapshot` (call :meth:`abandon` first)."""
        params, state, t = snap
        with self._commit_lock:
            self.params = list(params)
            self.state = {k: list(v) for k, v in state.items()}
            self.t = t

    # -- host bridges ------------------------------------------------------
    def _host(self, i: int, leaf) -> np.ndarray:
        if self.sharded:
            leaf = _gather_replicas(leaf, self._sizes[i], self._shapes[i], "cpu")
        return leaf.detach().to("cpu").numpy().copy()

    def params_host(self) -> list[np.ndarray]:
        """The updated parameters on the host; on the sharded plane this is
        the round's gather (timed for ``server/opt_allgather_time``)."""
        t0 = time.perf_counter()
        out = [self._host(i, p) for i, p in enumerate(self.params)]
        if self.sharded:
            self.last_allgather_s = time.perf_counter() - t0
        return out

    def state_host(self) -> dict[str, list[np.ndarray]]:
        return {k: [self._host(i, a) for i, a in enumerate(v)] for k, v in self.state.items()}

    def server_state_bytes_per_rank(self) -> int:
        """Persistent server-state bytes one replica rank holds between
        rounds (params and every optimizer-state tensor, fp32): each leaf
        counts its chunk on the sharded plane, its full size replicated."""
        per_leaf = self._chunks if self.sharded else self._sizes
        return 4 * sum(per_leaf) * (1 + len(self.state_keys))

    def shard_fraction(self) -> float:
        """Per-rank fraction of the full server state this plane keeps
        (``server/opt_shard_frac``): 1.0 replicated, ≈1/replica sharded."""
        return sum(self._chunks if self.sharded else self._sizes) / max(sum(self._sizes), 1)

    def sync_strategy(self, strategy: Any) -> None:
        """Mirror the device round's results into the host strategy, so
        ``Strategy.state_for_checkpoint`` and the broadcast see them."""
        strategy.current_parameters = self.params_host()
        strategy.restore_optimizer_state(self.state_host(), t=self.t)

    def reseed_from(self, strategy: Any) -> None:
        """Inverse of :meth:`sync_strategy`: re-seed params/state from the
        host strategy after a round ran off the plane (a survivors cohort,
        the host fallback); ``t`` follows the host strategy's ``_t``."""
        if strategy.current_parameters is None:
            raise RuntimeError("strategy not initialized with parameters")
        with self._commit_lock:
            self._seed_from_host(strategy)
            self.t = int(getattr(strategy, "_t", self.t))

    def modeled_round_bytes(self) -> int:
        """Modeled cross-client bytes of one round over this plane's
        payload (:func:`modeled_cross_slice_bytes`)."""
        return modeled_cross_slice_bytes(list(self._sizes), self.n_clients,
                                         replica=self.replica,
                                         quantization=self.quantization, block=self.block)
