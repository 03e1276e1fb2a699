"""Row-striped ptychographic reconstruction: the object split over a mesh.

Counterpart of :mod:`tike_tpu.parallel.striped`, the original tike's
object decomposition, for objects larger than one card's memory: each
shard of a mesh reconstructs a row stripe of psi that covers its own scan
positions plus a halo, the stripes reduce what they share once an epoch,
the neighbours cross-fade their shared rows, and the stripes are stitched
at the end.

Each shard owns

- a window of psi of R = Hs + 2 halo rows (stripe height Hs = ceil(H / n),
  halo = probe width + 1 + a margin for the positions' drift), padded with
  1 outside the object;
- its stripe's diffraction patterns in batch-major layout, on its device
  or streamed from the host (``ptycho.stream``), its scan positions in its
  window's rows, padded to a common capacity, and mini-batches clustered
  within the stripe (as the original tike clusters them);
- its own copy of the probe, the eigen probes, the eigen weights of its
  positions and the moment states.

Each stripe runs the epoch of the replicated path
(``ptycho.solvers.epoch._epoch_steps``) with a
:class:`~tike_tpu_torch.ptycho.solvers.epoch.StripeComm`; the stripes'
epochs run in lockstep (``parallel.run_shards``) and meet where the JAX
package's striped epoch reduces over stripes: the pooled probe
preconditioner, the global epoch cost, the weighted means of the probe and
eigen probes, the halo cross-fade and the mean-abs rescale. So the striped
path runs every solver feature of the epoch: eigen probes, position
correction, adaptive moments, the probe constraints and schedule, the
object constraints and both rescale methods. The patch kernels of
``csrc/patch.cu`` run on each stripe's window.

Across processes (a mesh of :func:`~tike_tpu_torch.parallel.distributed.global_mesh`),
each process sets up and runs its own shards' stripes alone, from the full
data or from its :func:`striped_local_indices` rows, and the stripes meet
through the mesh's collectives; a process whose stripes hold no position
takes part with a block of no rows. The stitched results are gathered from
every process, so every process must call the functions that return them.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
import typing

import numpy as np
import torch

from .. import cluster, trace
from ..ops.ptycho import PtychoConfig
from ..precision import to_numpy
from ..ptycho.exitwave import ExitWaveOptions
from ..ptycho.solvers.epoch import (
    EpochPlan,
    EpochState,
    StripeComm,
    _epoch_steps,
    seed_err_hist,
)
from ..ptycho.solvers.lstsq import _POS_EDGE
from ..ptycho.solvers.options import _batch_tensors
from ..ptycho.stream import StreamedBatches, pinned_batches
from ._mesh import Mesh, all_gather, gather_objects, run_shards

__all__ = [
    "StripePlan",
    "StripedState",
    "estimate_probe_rescale",
    "estimate_probe_rescale_multihost",
    "local_row_lookup",
    "plan_stripes",
    "reconstruct_striped",
    "setup_striped",
    "setup_striped_full",
    "stitch",
    "striped_epoch",
    "striped_full_result",
    "striped_iterate",
    "striped_result",
    "striped_scan_global",
    "striped_local_indices",
    "striped_set_scan",
]


@dataclasses.dataclass(frozen=True)
class StripePlan:
    """Host-side geometry of a row-striped decomposition."""

    ndev: int
    stripe_height: int  # Hs: interior rows per stripe
    halo: int  # overlap rows shared with each neighbor
    local_height: int  # R = Hs + 2*halo
    width: int
    assignment: np.ndarray  # (N,) stripe index of each scan position
    counts: np.ndarray  # (ndev,) positions per stripe
    capacity: int  # padded per-stripe position count


def plan_stripes(
    scan: np.ndarray,
    object_shape: typing.Tuple[int, int],
    probe_width: int,
    ndev: int,
    position_margin: int = 8,
) -> StripePlan:
    """Assign scan positions to row stripes, as
    :func:`tike_tpu.parallel.striped.plan_stripes` does.

    ``position_margin`` extends the halo beyond the probe footprint so that
    fractional offsets and (bounded) position-correction drift never read
    or write outside the local window.
    """
    h, w = object_shape
    hs = -(-h // ndev)
    halo = probe_width + 1 + max(int(position_margin), 1)
    assignment = np.clip((np.floor(scan[:, 0]).astype(np.int64)) // hs, 0, ndev - 1)
    counts = np.bincount(assignment, minlength=ndev)
    capacity = int(counts.max())
    return StripePlan(
        ndev=ndev,
        stripe_height=hs,
        halo=halo,
        local_height=hs + 2 * halo,
        width=w,
        assignment=assignment,
        counts=counts,
        capacity=capacity,
    )


def stitch(plan: StripePlan, psi_s: np.ndarray, h: int) -> np.ndarray:
    """Crop each stripe's interior rows and concatenate (``join_psi``)."""
    parts = [
        psi_s[k][:, plan.halo : plan.halo + plan.stripe_height] for k in range(plan.ndev)
    ]
    return np.concatenate(parts, axis=-2)[:, :h]


def estimate_probe_rescale(
    data: np.ndarray,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    sample: int = 256,
    rng: typing.Optional[np.random.Generator] = None,
) -> float:
    """Host-side probe power rescale factor, as
    :func:`tike_tpu.parallel.striped.estimate_probe_rescale` computes it.

    By Parseval (ortho-norm FFT), the modeled far-field energy of a
    position equals sum_px |patch|^2 * sum_modes |probe|^2, so the rescale
    sqrt(sum data / sum model) is computed from bilinear patches of up to
    ``sample`` positions drawn from ``rng``, without a forward FFT and
    without the whole object on one device.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    sel = _rescale_sample(scan.shape[0], sample, rng)
    model = _sampled_model_power(psi, probe, scan, sel)
    measured = float(np.sum(data[sel]))
    return float(np.sqrt(measured / (model + 1e-32)))


def estimate_probe_rescale_multihost(
    data_local,
    local_indices: np.ndarray,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    sample: int = 256,
    rng: typing.Optional[np.random.Generator] = None,
) -> float:
    """:func:`estimate_probe_rescale` over data spread across processes, as
    :func:`tike_tpu.parallel.striped.estimate_probe_rescale_multihost`
    computes it. Every process passes the same psi, probe and scan and an
    identically seeded ``rng`` (so the sample agrees), and its own data
    block, whose rows are ``scan[local_indices]``. The model's power comes
    from the shared arrays in every process. The sampled patterns are
    gathered from the processes that hold them and summed in the sample's
    order, so where the blocks cover the sample the scale is
    :func:`estimate_probe_rescale`'s of the whole data, bit for bit (the
    JAX package adds the processes' partial sums, which rounds otherwise).
    Every process must call it."""
    rng = np.random.default_rng(0) if rng is None else rng
    sel = _rescale_sample(scan.shape[0], sample, rng)
    model = _sampled_model_power(psi, probe, scan, sel)
    data_local = to_numpy(data_local)
    rows = local_row_lookup(scan.shape[0], local_indices)[sel]
    mine = np.flatnonzero(rows >= 0)
    sampled = np.empty((len(sel), *data_local.shape[1:]), data_local.dtype)
    found = np.zeros(len(sel), bool)
    for where, patterns in gather_objects((mine, data_local[rows[mine]])):
        sampled[where] = patterns
        found[where] = True
    measured = float(np.sum(sampled[found]))
    return float(np.sqrt(measured / (model + 1e-32)))


def striped_local_indices(
    scan: np.ndarray,
    object_shape: typing.Tuple[int, int],
    probe_width: int,
    mesh: Mesh,
    position_margin: int = 8,
) -> np.ndarray:
    """The global scan indices whose stripes this process owns, ascending:
    the rows of the data that this process loads and passes to the striped
    set-up (the original ``MPIio_ptycho``'s contract)."""
    plan = plan_stripes(
        np.asarray(scan), object_shape, probe_width, mesh.size,
        position_margin=position_margin,
    )
    return np.flatnonzero(np.isin(plan.assignment, mesh.local))


def local_row_lookup(n: int, local_indices: np.ndarray) -> np.ndarray:
    """(n,) map from global position index to this process's data row:
    entry i is the row of the local block holding global position i, or -1
    when this process does not own it."""
    lookup = np.full(n, -1, np.int64)
    lookup[np.asarray(local_indices)] = np.arange(len(local_indices))
    return lookup


def _rescale_sample(n: int, sample: int, rng: np.random.Generator) -> np.ndarray:
    return np.arange(n) if n <= sample else rng.choice(n, size=sample, replace=False)


def _sampled_model_power(
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    sel: np.ndarray,
) -> float:
    p = probe.shape[-1]
    probe_power = np.sum(np.abs(probe[0, 0]) ** 2, axis=0)  # (P, P)
    corner = np.floor(scan[sel]).astype(np.int64)
    frac = scan[sel] - corner
    model = 0.0
    for c, f in zip(corner, frac):
        win = psi[0, c[0] : c[0] + p + 1, c[1] : c[1] + p + 1]
        fy, fx = f
        patch = (
            (1 - fy) * (1 - fx) * win[:-1, :-1]
            + (1 - fy) * fx * win[:-1, 1:]
            + fy * (1 - fx) * win[1:, :-1]
            + fy * fx * win[1:, 1:]
        )
        model += float(np.sum(np.abs(patch) ** 2 * probe_power))
    return model


@dataclasses.dataclass
class StripedState:
    """A striped reconstruction in progress: per stripe of this process
    (``own``; every stripe in one process), in mesh order, its solver
    state (an ``EpochState`` on its device, psi its window), its
    batch-major data (a tensor on its device, or a
    :class:`~tike_tpu_torch.ptycho.stream.StreamedBatches` of host data),
    its padded batches and its :class:`StripeComm`."""

    plan: StripePlan
    epoch_plan: EpochPlan  # cfg.nz is the window height R
    mesh: Mesh
    height: int  # global object rows (for stitching)
    order: typing.List[np.ndarray]  # per-stripe global indices, batch order
    states: typing.List[EpochState]
    data: list
    batch_idx: typing.List[torch.Tensor]  # (nb, L) int64
    batch_mask: typing.List[torch.Tensor]  # (nb, L) float32
    batch_real: typing.List[list]
    comms: typing.List[StripeComm]
    exitwave_options: typing.List[ExitWaveOptions]
    own: typing.List[int]  # the stripes of this process, as states
    epochs_done: int = 0
    last_powers: typing.Any = None  # (E, modes) per-epoch probe mode power
    setup_seconds: dict = dataclasses.field(default_factory=dict)
    _rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0)
    )

    def _nb(self) -> int:
        return int(self.batch_idx[0].shape[0])


def _stripe_data(data, rows: np.ndarray, device, resident: bool):
    """Stripe data (nb, L, DET, DET) float32 whose slot ``(b, l)`` holds
    ``data[rows[b, l]]``, and zeros where ``rows`` is -1 (padding): on
    ``device``, or streamed to it from the host (pinned for a card). A
    stripe without positions may come with data of no rows."""
    if data.shape[0] == 0:
        data = torch.zeros((1, *data.shape[1:]), dtype=torch.float32)
    host = pinned_batches(
        data, np.maximum(rows, 0).reshape(-1), rows.shape, "cpu" if resident else device
    )
    host[torch.as_tensor(rows < 0)] = 0.0
    if resident:
        return host.to(device)
    return StreamedBatches(host, device)


def setup_striped_full(
    data,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    *,
    mesh: Mesh,
    epoch_plan: EpochPlan,
    batch_method: str = "compact",
    num_batch: int = 1,
    eigen_probe: typing.Optional[np.ndarray] = None,
    eigen_weights: typing.Optional[np.ndarray] = None,
    measured_pixels: typing.Optional[np.ndarray] = None,
    step_length_start: float = 0.5,
    step_length_weight: float = 0.5,
    unmeasured_pixels_scaling: float = 1.0,
    position_margin: int = 8,
    pos_momentum: typing.Optional[np.ndarray] = None,
    prev_costs: typing.Sequence[float] = (),
    rng: typing.Optional[np.random.Generator] = None,
    epochs_done: int = 0,
    store_data_on_device: bool = True,
) -> StripedState:
    """Split the solver state into row stripes, one a shard of ``mesh``.

    ``data`` (N, DET, DET) is host data (numpy or a CPU tensor).
    ``epoch_plan`` carries the whole solver configuration, the
    ``EpochPlan`` of the replicated path; its ``cfg.nz`` becomes the window
    height here. Mini-batches are clustered within each stripe with
    ``batch_method`` from ``rng`` (stripe after stripe), then padded to a
    common capacity, as :func:`tike_tpu.parallel.striped.setup_striped_full`
    lays them out. With ``store_data_on_device=False`` each stripe's data
    stays on the host and is streamed one batch at a time.

    On a mesh across processes this process sets up its own stripes alone
    (the plan and the clustering are computed alike everywhere, so pass
    an identically seeded ``rng``), and ``data`` is the full array or this
    process's :func:`striped_local_indices` rows.
    """
    started = time.perf_counter()
    rng = np.random.default_rng(0) if rng is None else rng
    ndev = mesh.size
    devices = mesh.flat
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu()
    psi = np.asarray(psi)
    scan = np.asarray(scan)
    d, h, w = psi.shape
    p = probe.shape[-1]
    det = data.shape[-1]
    plan = plan_stripes(scan, (h, w), p, ndev, position_margin=position_margin)
    num_batch = max(1, int(num_batch))
    own = mesh.local
    lookup = None
    if len(own) < ndev and data.shape[0] != scan.shape[0]:
        local_idx = np.flatnonzero(np.isin(plan.assignment, own))
        if data.shape[0] != len(local_idx):
            raise ValueError(
                f"data has {data.shape[0]} patterns but this process's stripes "
                f"cover {len(local_idx)} (or pass the full {scan.shape[0]})"
            )
        lookup = local_row_lookup(scan.shape[0], local_idx)

    # Per-stripe mini-batch clustering.
    method = cluster.BATCH_METHODS[batch_method]
    takes_rng = "rng" in inspect.signature(method).parameters
    order: typing.List[np.ndarray] = []
    per_stripe = []
    L = 1
    for k in range(ndev):
        sel = np.flatnonzero(plan.assignment == k)
        if len(sel):
            if takes_rng:
                local_batches = method(scan[sel], num_batch, rng=rng)
            else:
                local_batches = method(scan[sel], num_batch)
        else:
            local_batches = [np.zeros(0, np.int64) for _ in range(num_batch)]
        # The stripe's positions batch-contiguously, so batch rows are ranges.
        contiguous = sel[np.concatenate(local_batches)] if len(sel) else sel
        order.append(contiguous)
        sizes = [len(b) for b in local_batches]
        breaks = np.cumsum(sizes)[:-1]
        local_ranges = np.array_split(np.arange(len(contiguous)), breaks)
        idx_k, mask_k = cluster.batches_padded(local_ranges)
        per_stripe.append((idx_k, mask_k))
        L = max(L, idx_k.shape[1])
    nb = num_batch
    cap = max(1, max(len(o) for o in order))
    clustered = time.perf_counter()

    cfg = dataclasses.replace(
        epoch_plan.cfg,
        probe_shape=p,
        detector_shape=det,
        nz=plan.local_height,
        n=w,
        nslices=d,
    )
    plan_static = dataclasses.replace(epoch_plan, cfg=cfg)
    if measured_pixels is None:
        measured_pixels = np.ones((det, det), bool)
    # Local psi windows: rows [k*Hs - halo, k*Hs + Hs + halo), padded with
    # the background value outside the global object.
    psi_pad = np.pad(
        psi,
        ((0, 0), (plan.halo, plan.halo + ndev * plan.stripe_height - h), (0, 0)),
        constant_values=1.0,
    )
    eh = seed_err_hist(prev_costs)
    gshape = (p, p) if plan_static.solver == "rpie" else (1, 1, p, p)
    states, datas, idxs, masks, reals, comms, ews = [], [], [], [], [], [], []
    for k in own:
        device = devices[k]
        sel = order[k]
        nk = len(sel)
        idx_k, mask_k = per_stripe[k]
        lk = idx_k.shape[1]
        bidx = np.zeros((nb, L), np.int64)
        bmask = np.zeros((nb, L), np.float32)
        bidx[:, :lk] = idx_k
        bmask[:, :lk] = mask_k
        rows = np.full((nb, L), -1, np.int64)
        scan_s = np.zeros((cap, 2), np.float32)
        pos_mask = np.zeros(cap, np.float32)
        row_mask = np.zeros(plan.local_height, np.float32)
        ew_s = None
        if eigen_weights is not None:
            ew_s = np.zeros((cap, *eigen_weights.shape[-2:]), np.float32)
        pvm = None if pos_momentum is None else np.zeros((cap, 4), np.float32)
        if nk:
            local = scan[sel].copy()
            local[:, 0] += plan.halo - k * plan.stripe_height
            scan_s[:nk] = local
            # Padded capacity slots duplicate a real position (mask 0).
            scan_s[nk:] = local[0]
            pos_mask[:nk] = 1.0
            for b in range(nb):
                valid = mask_k[b] > 0
                local_rows = idx_k[b][valid]
                rows[b, : len(local_rows)] = sel[local_rows]
            if ew_s is not None:
                ew_s[:nk] = eigen_weights[sel]
            if pvm is not None:
                pvm[:nk] = pos_momentum[sel]
        else:
            scan_s[:] = (plan.halo + 1, 1)
        lo = k * plan.stripe_height
        hi = min((k + 1) * plan.stripe_height, h)
        if hi > lo:
            row_mask[plan.halo : plan.halo + (hi - lo)] = 1.0

        def on(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        window = psi_pad[:, lo : lo + plan.local_height].astype(np.complex64)
        state = EpochState(
            psi=on(window, torch.complex64),
            probe=on(probe, torch.complex64),
            scan=on(scan_s, torch.float32),
            eigen_probe=None if eigen_probe is None else on(eigen_probe, torch.complex64),
            eigen_weights=None if ew_s is None else on(ew_s, torch.float32),
            err_hist=on(eh, torch.float32),
        )
        if plan_static.recover_positions and plan_static.pos_use_adaptive_moment:
            mom = np.zeros((cap, 4), np.float32) if pvm is None else pvm
            state.pos_v = on(mom[:, 0:2], torch.float32)
            state.pos_m = on(mom[:, 2:4], torch.float32)
        window_shape = tuple(state.psi.shape)
        if plan_static.obj_moment != "none":
            state.obj_m = torch.zeros(window_shape, dtype=torch.complex64, device=device)
            if plan_static.obj_moment == "adam":
                state.obj_v = torch.zeros(window_shape, dtype=torch.float32, device=device)
            elif plan_static.obj_moment == "checked":
                state.obj_v = torch.zeros(
                    (3, *window_shape), dtype=torch.complex64, device=device
                )
        if plan_static.probe_moment != "none":
            state.probe_m = torch.zeros(gshape, dtype=torch.complex64, device=device)
            if plan_static.probe_moment == "adam":
                state.probe_v = torch.zeros(gshape, dtype=torch.float32, device=device)
            else:
                state.probe_v = torch.zeros(
                    (3, *gshape), dtype=torch.complex64, device=device
                )
        states.append(state)
        if lookup is not None:
            rows = np.where(rows >= 0, lookup[np.maximum(rows, 0)], -1)
        datas.append(_stripe_data(data, rows, device, store_data_on_device))
        idx_t, mask_t, real_t = _batch_tensors((bidx, bmask), device)
        idxs.append(idx_t)
        masks.append(mask_t)
        reals.append(real_t)
        comms.append(
            StripeComm(
                index=k,
                size=ndev,
                halo=plan.halo,
                hs=plan.stripe_height,
                height=h,
                row_mask=on(row_mask, torch.float32),
                pos_mask=on(pos_mask, torch.float32),
            )
        )
        ews.append(
            ExitWaveOptions(
                measured_pixels=on(measured_pixels, torch.bool),
                step_length_start=step_length_start,
                step_length_weight=step_length_weight,
                unmeasured_pixels_scaling=unmeasured_pixels_scaling,
                noise_model=plan_static.noise_model,
                step_length_usemodes=plan_static.steplength_usemodes,
            )
        )
    return StripedState(
        plan=plan,
        epoch_plan=plan_static,
        mesh=mesh,
        height=h,
        order=order,
        states=states,
        data=datas,
        batch_idx=idxs,
        batch_mask=masks,
        batch_real=reals,
        comms=comms,
        exitwave_options=ews,
        own=own,
        epochs_done=epochs_done,
        setup_seconds={
            "clustering": clustered - started,
            "data": time.perf_counter() - clustered,
        },
        _rng=rng,
    )


def striped_iterate(state: StripedState, n_epochs: int) -> typing.List[float]:
    """Advance ``n_epochs`` epochs in place; return the per-epoch costs.

    Compact batching runs each stripe's batches in order; the other batch
    methods in a permutation drawn per epoch from the state's generator
    (one for all stripes, as in the JAX package). The stripes' epochs run
    in lockstep; the costs and probe powers stay on the device until all
    epochs have run. Streamed stripes copy each batch in while the one
    before computes.
    """
    nb = state._nb()
    plan = state.epoch_plan
    costs, powers = [], []
    for _ in range(n_epochs):
        order = range(nb) if plan.compact else state._rng.permutation(nb).tolist()
        steps = [
            _epoch_steps(
                plan,
                state.data[k],
                state.batch_idx[k],
                state.batch_mask[k],
                state.batch_real[k],
                order,
                state.states[k],
                state.exitwave_options[k],
                state.epochs_done,
                state.comms[k],
            )
            for k in range(len(state.states))
        ]
        with trace.span("tike.epoch"):
            cost, pwr = run_shards(state.mesh.flat, steps)[0]
        costs.append(cost)
        powers.append(pwr)
        state.epochs_done += 1
    with trace.host_read("ptycho.powers"):
        state.last_powers = to_numpy(torch.stack(powers))
    with trace.host_read("ptycho.costs"):
        return [float(c) for c in to_numpy(torch.stack(costs))]


def striped_epoch(state: StripedState) -> float:
    """Advance one epoch in place; return its cost."""
    return striped_iterate(state, 1)[0]


def _windows(state: StripedState, name: str) -> np.ndarray:
    """Every stripe's ``name`` field stacked on the host, in mesh order;
    across processes gathered from their owners (every process calls)."""
    parts = [getattr(s, name)[None] for s in state.states]
    return to_numpy(all_gather(parts, state.mesh.flat)[0])


def striped_result(state: StripedState) -> typing.Tuple[np.ndarray, np.ndarray]:
    """Stitch the stripes back into (psi (D, H, W), probe)."""
    return (
        stitch(state.plan, _windows(state, "psi"), state.height),
        to_numpy(state.states[0].probe),
    )


def striped_scan_global(state: StripedState) -> np.ndarray:
    """Scan positions reassembled in the original global order."""
    n_total = sum(len(o) for o in state.order)
    with trace.host_read("position.scan"):
        scan_l = _windows(state, "scan")
    scan_g = np.zeros((n_total, 2), np.float32)
    for k, sel in enumerate(state.order):
        local = scan_l[k, : len(sel)].copy()
        local[:, 0] -= state.plan.halo - k * state.plan.stripe_height
        scan_g[sel] = local
    return scan_g


def striped_set_scan(state: StripedState, scan_g: np.ndarray) -> None:
    """Write corrected global positions back into the stripe layout.

    The inverse of :func:`striped_scan_global`: re-offsets each stripe's
    rows into its window, clamps them as the epoch's position step does
    (the window less 2 rows, intersected with the global window), and
    leaves the padded slots as they are. Every process passes the same
    global positions and writes its own stripes.
    """
    cfg = state.epoch_plan.cfg
    p = cfg.probe_shape
    for k, s in zip(state.own, state.states):
        sel = state.order[k]
        with trace.host_read("position.scan"):
            scan_l = to_numpy(s.scan).copy()
        local = np.asarray(scan_g[sel], np.float32).copy()
        off = state.plan.halo - k * state.plan.stripe_height
        local[:, 0] += off
        local[:, 0] = np.clip(
            local[:, 0],
            max(1.0, 1.0 + off),
            min(cfg.nz - p - 2.0, state.height - p - _POS_EDGE + off),
        )
        local[:, 1] = np.clip(local[:, 1], 1.0, cfg.n - p - _POS_EDGE)
        scan_l[: len(sel)] = local
        s.scan = torch.as_tensor(scan_l, device=s.scan.device)


def striped_full_result(state: StripedState) -> dict:
    """All solver state reassembled in the original global position order."""
    n_total = sum(len(o) for o in state.order)
    first = state.states[0]
    has_eigen = first.eigen_weights is not None
    out = {
        "psi": stitch(state.plan, _windows(state, "psi"), state.height),
        "probe": to_numpy(first.probe),
        "eigen_probe": to_numpy(first.eigen_probe) if has_eigen else None,
        "scan": striped_scan_global(state),
        "eigen_weights": None,
    }
    if has_eigen:
        ew_l = _windows(state, "eigen_weights")
        ew_g = np.zeros((n_total, *ew_l.shape[2:]), ew_l.dtype)
        for k, sel in enumerate(state.order):
            ew_g[sel] = ew_l[k, : len(sel)]
        out["eigen_weights"] = ew_g
    if state.epoch_plan.recover_positions:
        mom = np.zeros((n_total, 4), np.float32)
        if first.pos_v is not None:
            pos_v, pos_m = _windows(state, "pos_v"), _windows(state, "pos_m")
            for k, sel in enumerate(state.order):
                mom[sel, 0:2] = pos_v[k, : len(sel)]
                mom[sel, 2:4] = pos_m[k, : len(sel)]
        out["position_momentum"] = mom
    return out


def _default_plan(
    solver: str,
    noise_model: str,
    alpha: float,
    num_batch: int,
    recover_probe: bool = True,
) -> EpochPlan:
    """Minimal EpochPlan for the functional striped API."""
    return EpochPlan(
        cfg=PtychoConfig(probe_shape=1, detector_shape=1, nz=1, n=1),
        solver=solver,
        compact=True,
        noise_model=noise_model,
        steplength_usemodes="all_modes",
        recover_psi=True,
        recover_probe=recover_probe,
        has_eigen=False,
        update_start=0,
        update_period=1,
        force_sparsity=1.0,
        rescale_mean_abs=False,
        rescale_period=10**9,
        alpha=alpha,
    )


def setup_striped(
    data,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    *,
    mesh: Mesh,
    solver: str = "rpie",
    noise_model: str = "gaussian",
    alpha: float = 0.05,
    position_margin: int = 8,
    num_batch: int = 1,
    recover_probe: bool = True,
) -> StripedState:
    """Shard the problem into row stripes (compact batches): the functional
    entry with the JAX package's signature. ``Reconstruction(...,
    object_sharding="striped")`` builds the whole plan from the parameters
    instead."""
    if solver not in ("rpie", "lstsq"):
        raise ValueError(f"striped mode supports rpie/lstsq, not {solver!r}")
    plan = _default_plan(solver, noise_model, alpha, num_batch, recover_probe)
    return setup_striped_full(
        data,
        np.asarray(psi),
        probe,
        scan,
        mesh=mesh,
        epoch_plan=plan,
        batch_method="compact",
        num_batch=num_batch,
        position_margin=position_margin,
    )


def reconstruct_striped(
    data,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    *,
    mesh: Mesh,
    num_iter: int,
    solver: str = "rpie",
    noise_model: str = "gaussian",
    alpha: float = 0.05,
    num_batch: int = 1,
) -> typing.Tuple[np.ndarray, np.ndarray, list]:
    """Row-striped reconstruction over a mesh (functional API): psi lives
    only as per-shard stripes, the probe is replicated and reduced.

    Returns (stitched psi (D, H, W), probe, costs per epoch).
    """
    state = setup_striped(
        data,
        np.asarray(psi),
        probe,
        scan,
        mesh=mesh,
        solver=solver,
        noise_model=noise_model,
        alpha=alpha,
        num_batch=num_batch,
    )
    costs = striped_iterate(state, num_iter)
    psi_out, probe_out = striped_result(state)
    return psi_out, probe_out, costs
