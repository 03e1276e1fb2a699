"""One rPIE or LSQML solver epoch as an eager PyTorch loop.

Counterpart of :mod:`tike_tpu.ptycho.solvers.fused`, which folds whole
epochs into one XLA program and therefore gates epoch-dependent steps with
traced ``jnp.where`` predicates. Here PyTorch runs eagerly, so the same
steps are plain Python ``if`` statements over the same math, which is
bitwise the same where the gate is 0 or 1:

1. :func:`_epoch_begin_math`: the probe constraints (applied on
   probe-recovery epochs), the probe power, the periodic
   ``constant_probe_photons`` rescale, and the whole-epoch object and
   probe preconditioners, in the gather or the FFT formulation;
2. :func:`_batch_update_math`: one mini-batch. In compact mode psi is
   fixed during the sweep and the updates are summed; otherwise each batch
   steps psi (rPIE with optional AdaM, LSQML with optional momentum). The
   probe, the eigen probes and the batch's eigen weights move every batch,
   except rPIE's compact probe, which moves at the epoch end;
3. :func:`_epoch_end_math`: the position step, the compact updates with
   their checked momenta, the eigen-weight normalisation (rPIE), the
   object constraints, then the periodic mean-abs object/probe rescale.

Batches run in the order the caller gives: 0..nb-1 in compact mode, a
permutation drawn per epoch otherwise. Moment states advance as in
``fused.py``: the object's every epoch, the probe's only on probe-recovery
epochs. The eigen probes are constrained (``constrain_variable_probe``,
after the probe constraints and the photon rescale, on probe-recovery
epochs) only where the plan asks for it: on the per-epoch path, as the JAX
package's per-epoch loop does and its fused program does not.

On a mesh (``data`` a :class:`ShardedBatches`) each batch's slots are
split over the shards: each shard runs the batch math on its slots, on its
device, with the replicated state copied there, and the shards' partial
sums over slots are reduced where the JAX package's GSPMD program reduces
them (``parallel.run_shards``; see ``lstsq._lstsq_batch_steps`` and
``rpie._batch_gradients_steps``), as are the preconditioners' point
densities. Every shard then holds the whole batch's result, and the first
shard's is applied once to the state, which lives on the first shard's
device: the shards read it from there at the next batch. A mesh of one
shard computes what no mesh computes, bit for bit.

The striped object (:mod:`tike_tpu_torch.parallel.striped`) runs this
epoch once a stripe, on the stripe's window of psi, as a generator
(:func:`_epoch_steps` with a :class:`StripeComm`) that yields where the
stripes reduce: the probe preconditioner, the epoch cost, the probe's and
eigen probes' weighted means, the seams' cross-fade and the mean-abs
rescale. Without a comm it makes no request, so the paths above compute
what they did before, bit for bit.

:func:`solver_epoch`, the body of the per-epoch solver functions
``solvers.rpie`` and ``solvers.lstsq_grad``, runs steps 2 and 3 alone: the
preconditioners come from the options (``update_preconditioners``), no
constraint or rescale runs, and the checked momenta decide on the host
from the cost history, as the JAX package's functions of those names do.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ... import opt
from ...ops.ptycho import PtychoConfig
from ...parallel import Gather, Mesh, Sum, put, batch_sharding, run_local, run_shards
from ...parallel.halo import cross_fade
from ...precision import as_tensor, to_numpy
from .. import object as object_module
from .. import probe as probe_module
from ..stream import StreamedBatches, iter_batches
from ._preconditioner import _batched_preconditioners
from .options import _batch_tensors, _device_fields
from .lstsq import (
    _POS_EDGE,
    _fz,
    _lstsq_batch_steps,
    _masked_trim_mean,
    _precondition_object_update,
    _trim_mean,
)
from .rpie import _batch_gradients_steps, _normalize_eigen_weights


class _Shards(typing.NamedTuple):
    """One batch's slots split over a mesh: ``group``, every shard's device
    in mesh order (another process's a ``parallel.Remote``), and per shard
    of this process, in mesh order, its device, data (B/k, DET, DET),
    indices (B/k,) and mask (B/k,)."""

    group: list
    devices: list
    data: list
    idx: list
    mask: list


def shard_runs(mesh: Mesh, data, slots: int) -> list:
    """This process's shards' runs of the ``slots`` slots of each batch of
    ``data`` (nb, slots, DET, DET), or, on a mesh across processes, of its
    block of them (nb, slots k_local / k): each on its shard's device, or
    for host data (:class:`~tike_tpu_torch.ptycho.stream.StreamedBatches`)
    a view of the host tensor streamed through buffers and a copy stream
    of the shard's own."""
    k = slots // mesh.size
    streamed = isinstance(data, StreamedBatches)
    host = data.host if streamed else data
    whole = host.shape[1] == slots
    if not whole and host.shape[1] != k * len(mesh.local):
        raise ValueError(
            f"data has {host.shape[1]} slots a batch; the mesh's shards take {k} each "
            f"of {slots}"
        )
    runs = [
        host[:, s * k : (s + 1) * k]
        for s in (mesh.local if whole else range(len(mesh.local)))
    ]
    return [
        StreamedBatches(run, device, data.timing) if streamed else run.to(device)
        for run, device in zip(runs, mesh.local_devices)
    ]


@dataclasses.dataclass
class ShardedBatches:
    """Batch-major data and slots split over the shards of a mesh.

    The slots of each of the nb batches (``cluster.batches_padded(...,
    multiple_of=mesh.size)``) split into ``mesh.size`` equal runs in mesh
    order; this process keeps its shards' runs, each on its shard's device:
    ``data[s]`` (nb, L/k, DET, DET), ``idx[s]`` (nb, L/k) int64, ``mask[s]``
    (nb, L/k) float32. ``group`` lists every shard's device in mesh order
    and ``devices`` this process's. Shards on the device of the whole tensor
    take views of it, not copies. Host data
    (:class:`~tike_tpu_torch.ptycho.stream.StreamedBatches`) stays on the
    host: ``data[s]`` streams the shard's run of slots, a view of the host
    tensor, to its device, each shard through buffers and a copy stream of
    its own.
    """

    group: list
    devices: list
    data: list
    idx: list
    mask: list

    @classmethod
    def split(cls, mesh: Mesh, data, batch_idx, batch_mask) -> "ShardedBatches":
        """``data`` holds every slot of each batch (nb, L, DET, DET), or, on
        a mesh across processes, this process's shards' runs of them (nb,
        L k_local / k); ``batch_idx`` and ``batch_mask`` every slot."""
        sharding = batch_sharding(mesh, axis=1)
        return cls(
            mesh.flat, mesh.local_devices, shard_runs(mesh, data, batch_idx.shape[1]),
            put(batch_idx, sharding), put(batch_mask, sharding),
        )

    def batches(self, order):
        """``(n, _Shards of batch n)`` for each n of ``order``."""
        order = list(order)
        streams = [iter_batches(d, order) for d in self.data]
        for n in order:
            yield n, _Shards(
                self.group,
                self.devices,
                [next(stream)[1] for stream in streams],
                [i[n] for i in self.idx],
                [m[n] for m in self.mask],
            )


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """Static configuration of an rPIE or LSQML epoch."""

    cfg: PtychoConfig
    noise_model: str
    steplength_usemodes: str
    recover_psi: bool
    recover_probe: bool
    # probe update schedule
    update_start: int
    update_period: int
    # rescale
    rescale_mean_abs: bool
    rescale_period: int
    solver: str = "lstsq"  # 'lstsq' | 'rpie'
    compact: bool = True
    # FFT-formulation preconditioners (exact; see _preconditioner.py), for
    # one object slice only
    fft_precond: bool = False
    # eigen weights (and perhaps eigen probes) are part of the state
    has_eigen: bool = False
    # probe constraints
    probe_support: float = 0.0
    probe_support_radius: float = 0.35
    probe_support_degree: float = 2.5
    additional_probe_penalty: float = 0.0
    median_filter: bool = False
    median_filter_px: tuple = (1.0, 1.0)
    force_center: bool = False
    force_sparsity: float = 0.0
    force_orthogonality: bool = False
    # object constraints
    positivity: float = 0.0
    smoothness: float = 0.0
    clip_magnitude: bool = False
    # rPIE's step-length control
    alpha: float = 0.05
    # rescale_method='constant_probe_photons': the photon count, or 0 (off)
    rescale_photons: float = 0.0
    # adaptive moments: obj none | adam | momentum | checked;
    # probe none | adam | checked
    obj_moment: str = "none"
    probe_moment: str = "none"
    obj_vdecay: float = 0.999
    obj_mdecay: float = 0.9
    probe_vdecay: float = 0.999
    probe_mdecay: float = 0.9
    # position correction
    recover_positions: bool = False
    pos_update_start: int = 0
    pos_use_adaptive_moment: bool = False
    pos_vdecay: float = 0.999
    pos_mdecay: float = 0.9
    pos_update_magnitude_limit: float = 0.0
    # constrain_variable_probe at the start of probe-recovery epochs (the
    # per-epoch path with eigen probes)
    constrain_eigen: bool = False
    # the checked momenta decide on the host from EpochState.errors
    # (opt.momentum_checked, the per-epoch solver functions) rather than on
    # the device from EpochState.err_hist
    checked_on_host: bool = False

    def recover_now(self, total_e: int) -> bool:
        """Whether the probe is updated in epoch ``total_e``."""
        return total_e >= self.update_start and (
            total_e % self.update_period == 0
        )


@dataclasses.dataclass
class EpochState:
    """The solver state an epoch reads and returns, as device tensors.

    ``eigen_probe``/``eigen_weights`` are None without eigen probes or
    weights; ``pos_v``/``pos_m`` are the (N, 2) position AdaM moments, or
    None without ``use_adaptive_moment``. ``obj_v``/``obj_m`` and
    ``probe_v``/``probe_m`` are the object and probe moment states of the
    plan's moment kinds (None where a kind keeps none), and ``err_hist``
    the (3,) tail of the epoch-cost series that the checked momenta read
    on the device; ``errors`` the host list of the last epoch costs that
    they read with ``plan.checked_on_host``.
    """

    psi: torch.Tensor
    probe: torch.Tensor
    scan: torch.Tensor
    eigen_probe: typing.Optional[torch.Tensor] = None
    eigen_weights: typing.Optional[torch.Tensor] = None
    pos_v: typing.Optional[torch.Tensor] = None
    pos_m: typing.Optional[torch.Tensor] = None
    obj_v: typing.Optional[torch.Tensor] = None
    obj_m: typing.Optional[torch.Tensor] = None
    probe_v: typing.Optional[torch.Tensor] = None
    probe_m: typing.Optional[torch.Tensor] = None
    err_hist: typing.Optional[torch.Tensor] = None
    errors: typing.Optional[typing.List[float]] = None


@dataclasses.dataclass
class _Sums:
    """What the batches of one epoch add up: the compact object and probe
    updates, the position gradient terms, and LSQML's mean probe step and
    step size for its checked probe momentum."""

    psi: typing.Optional[torch.Tensor] = None
    probe: typing.Optional[torch.Tensor] = None
    pos_num: typing.Optional[torch.Tensor] = None
    pos_den: typing.Optional[torch.Tensor] = None
    pcomb: typing.Optional[torch.Tensor] = None
    pbeta: typing.Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class StripeComm:
    """One stripe's place in the striped object (:mod:`tike_tpu_torch.parallel.striped`).

    Counterpart of :class:`tike_tpu.ptycho.solvers.fused.StripeComm`. With
    it, an epoch runs on one stripe's window of psi (``R = hs + 2 halo``
    rows) and its positions, and yields :class:`~tike_tpu_torch.parallel.Sum`
    or :class:`~tike_tpu_torch.parallel.Gather` where the JAX package's
    striped epoch reduces over stripes, so that ``parallel.run_shards``
    drives the stripes' epochs in lockstep.

    ``index`` is the stripe's place among ``size``, ``hs`` its interior
    rows, ``halo`` the rows it shares with each neighbour and ``height``
    the global object's rows; ``row_mask`` (R,) float32 marks the interior
    rows that lie inside the object, ``pos_mask`` (cap,) float32 the real
    (not padded) positions.
    """

    index: int
    size: int
    halo: int
    hs: int
    height: int
    row_mask: torch.Tensor
    pos_mask: torch.Tensor


def seed_err_hist(prev_costs) -> np.ndarray:
    """(3,) tail of the epoch-cost series, right-aligned before the
    current slot: the checked momentum reads the last three costs after
    the epoch end appends the current one."""
    eh = np.full(3, np.inf, np.float32)
    tail = list(prev_costs)[-2:]
    if len(tail) >= 1:
        eh[2] = tail[-1]
    if len(tail) >= 2:
        eh[1] = tail[-2]
    return eh


def _probe_constraints_math(plan: EpochPlan, probe):
    """The per-epoch probe constraints, in the JAX package's order, and the
    constrained probe's mode powers (sorted when orthogonalized)."""
    if plan.probe_support > 0:
        b0 = probe_module.finite_probe_support(
            probe,
            p=plan.probe_support,
            radius=plan.probe_support_radius,
            degree=plan.probe_support_degree,
        )
        probe = probe - b0 * torch.conj(b0 * probe)
    if plan.additional_probe_penalty > 0:
        b1 = plan.additional_probe_penalty * torch.linspace(
            0, 1, probe.shape[-3], dtype=torch.float32, device=probe.device
        )[..., None, None]
        probe = probe - b1 * torch.conj(b1 * probe)
    if plan.median_filter:
        probe = probe_module.apply_median_filter_abs_probe(
            probe, med_filt_px=plan.median_filter_px
        )
    if plan.force_center:
        probe = probe_module.constrain_center_peak(probe)
    if plan.force_sparsity < 1:
        probe = probe_module.constrain_probe_sparsity(probe, f=plan.force_sparsity)
    if plan.force_orthogonality:
        return probe_module._orthogonalize_eig_body(probe)
    return probe, probe_module.power(probe)


def _epoch_begin_math(
    plan: EpochPlan, state: EpochState, batch_idx, batch_mask, recover_now, total_e,
    shards=None,
):
    """Start of an epoch: the probe constraints and rescale (into
    ``state.probe``) and the whole-epoch preconditioners.

    With ``plan.constrain_eigen`` the eigen probes and weights are then
    constrained on probe-recovery epochs (into ``state``), as the JAX
    package's per-epoch loop does after its probe constraints.

    On a mesh (``shards`` the :class:`ShardedBatches`) each shard adds up
    its own slots' part of the preconditioners and the parts are summed.
    Returns ``(pwr (modes,), psi_pre (D, H, W), probe_pre (D, P, P) or
    None)``, one preconditioner per object slice. As in ``fused.py``, ``pwr`` is the power of the constrained
    probe even on epochs where the constraints are not applied, so the
    constraints run whenever the probe is recovered. Only rPIE reads the
    probe preconditioner; the LSQML epoch does not compute it.
    """
    probe = state.probe
    if plan.recover_probe:
        constrained, pwr = _probe_constraints_math(plan, probe)
        if recover_now:
            probe = constrained
    else:
        pwr = probe_module.power(probe)
    if plan.rescale_photons > 0 and total_e % plan.rescale_period == 0:
        probe = probe_module.rescale_probe_using_fixed_intensity_photons(
            probe, Nphotons=plan.rescale_photons
        )
    state.probe = probe
    if (
        plan.constrain_eigen
        and plan.recover_probe
        and recover_now
        and state.eigen_probe is not None
    ):
        state.eigen_probe, state.eigen_weights = probe_module.constrain_variable_probe(
            state.eigen_probe, state.eigen_weights
        )
    psi_pre, probe_pre = _batched_preconditioners(
        plan.cfg,
        state.psi,
        state.scan,
        probe,
        batch_idx,
        batch_mask,
        use_fft=plan.fft_precond,
        want_psi=plan.recover_psi,
        want_probe=plan.solver == "rpie" and plan.recover_probe,
        shards=shards,
    )
    return pwr, psi_pre, probe_pre


def _rpie_denominator(pre, alpha: float, dims):
    """rPIE's ``(1 - alpha) * pre + alpha * max(pre)``, the max over ``dims``."""
    return (1 - alpha) * pre + alpha * torch.amax(torch.abs(pre), dim=dims, keepdim=True)


def _lstsq_batch(plan, out, state, sums, idx_n, real_n, recover_now, nb):
    """Apply one LSQML batch's result ``out``; return its object step."""
    if plan.recover_positions:
        sums.pos_num.index_add_(0, idx_n, out["pos_num"])
        sums.pos_den.index_add_(0, idx_n, out["pos_den"])
    beta_obj = torch.zeros((), dtype=torch.float32, device=state.psi.device)
    if plan.recover_psi:
        # On epochs where probe recovery is gated off, use the uncoupled
        # object step.
        beta = out["beta_object"]
        if not recover_now and "beta_object_solo" in out:
            beta = out["beta_object_solo"]
        beta_obj = beta.to(torch.float32).reshape(())
        if plan.compact:
            sums.psi = sums.psi + out["object_upd_sum"]
        else:
            dpsi = _fz(beta * out["object_update_precond"])
            if plan.obj_moment == "momentum":
                dpsi, _, state.obj_m = opt.momentum(
                    dpsi, None, state.obj_m, mdecay=plan.obj_mdecay
                )
            state.psi = state.psi + dpsi
    if plan.recover_probe:
        dprobe = out["beta_probe"] * out["m_probe_update"]
        if recover_now:
            state.probe = state.probe + dprobe
        if plan.probe_moment == "checked":
            sums.pcomb = sums.pcomb + dprobe / nb
            sums.pbeta = sums.pbeta + torch.mean(out["beta_probe"])
        if plan.has_eigen and recover_now:
            if out["eigen_probe"] is not None:
                state.eigen_probe = out["eigen_probe"]
            state.eigen_weights = state.eigen_weights.index_copy(
                0, idx_n[real_n], out["w_b"][real_n]
            )
    return beta_obj


def _rpie_batch(plan, nums, state, sums, idx_n, psi_pre, probe_pre, recover_now):
    """Apply one rPIE batch's numerators ``(psi_num, probe_num,
    eigen_delta)``."""
    psi_num, probe_num, eigen_delta = nums
    if plan.has_eigen and eigen_delta is not None and recover_now:
        # An add through the batch's indices: a padded slot repeats a real
        # index and adds its masked delta, 0.
        w = state.eigen_weights.clone()
        w[:, 0, 0].index_add_(0, idx_n, eigen_delta)
        state.eigen_weights = w
    if plan.compact:
        sums.psi = sums.psi + psi_num
        sums.probe = sums.probe + probe_num
        return
    if plan.recover_psi:
        deno = _rpie_denominator(psi_pre, plan.alpha, (-2, -1))
        state.psi = state.psi + _fz(psi_num / deno)
        if plan.obj_moment == "adam":
            # Both the plain and the AdaM step are added, as in fused.py.
            d2, state.obj_v, state.obj_m = opt.adam(
                psi_num,
                state.obj_v,
                state.obj_m,
                vdecay=plan.obj_vdecay,
                mdecay=plan.obj_mdecay,
            )
            state.psi = state.psi + _fz(d2 / deno)
    if plan.recover_probe and recover_now:
        ppre = torch.abs(probe_pre[0])
        pdeno = (1 - plan.alpha) * ppre + plan.alpha * ppre.max()
        probe = state.probe + _fz(probe_num[0] / pdeno)
        if plan.probe_moment == "adam":
            # Mode 0 alone, as in fused.py.
            d2, state.probe_v, state.probe_m = opt.adam(
                probe_num[0][0, 0, 0],
                state.probe_v,
                state.probe_m,
                vdecay=plan.probe_vdecay,
                mdecay=plan.probe_mdecay,
            )
            probe = probe.clone()
            probe[0, 0, 0] += d2 / pdeno
        state.probe = probe


def _batch_steps(
    plan: EpochPlan, device, data_n, idx_n, mask_n, state: EpochState, psi_pre,
    exitwave_options, nb: int, n_slots: int,
):
    """The batch math of one shard's slots on its ``device``, the state
    read there (a copy where it lives on another device), as a generator
    for ``parallel.run_shards`` or ``run_local``: LSQML's dict, or rPIE's
    ``(costs, psi_num, probe_num, eigen_delta)``, of the whole batch."""
    ew = exitwave_options

    def on(x):
        return None if x is None else x.to(device)

    args = (
        plan.cfg,
        data_n,
        on(state.scan),
        idx_n,
        mask_n,
        on(state.psi),
        on(state.probe),
        on(state.eigen_probe) if plan.has_eigen else None,
        on(state.eigen_weights) if plan.has_eigen else None,
        on(ew.measured_pixels),
    )
    steps = (ew.step_length_start, ew.step_length_weight, ew.unmeasured_pixels_scaling)
    modes = dict(
        noise_model=plan.noise_model, steplength_usemodes=plan.steplength_usemodes
    )
    if plan.solver == "lstsq":
        return (
            yield from _lstsq_batch_steps(
                *args,
                on(psi_pre),
                *steps,
                num_batch=float(nb),
                recover_psi=plan.recover_psi,
                recover_probe=plan.recover_probe,
                recover_positions=plan.recover_positions,
                n_slots=n_slots,
                **modes,
            )
        )
    return (
        yield from _batch_gradients_steps(
            *args, *steps, recover_probe=plan.recover_probe, **modes
        )
    )


def _batch_update_math(
    plan: EpochPlan,
    data_n,
    idx_n,
    mask_n,
    real_n,
    state: EpochState,
    sums: _Sums,
    psi_pre,
    probe_pre,
    exitwave_options,
    recover_now: bool,
    nb: int,
):
    """One mini-batch against the epoch's preconditioners.

    ``real_n`` holds the slots of the batch with ``mask_n > 0``: LSQML's
    new eigen weights are written back through those alone. A padded slot
    repeats a real position's index, and a scatter with repeated indices
    leaves the write order undefined (``tike_tpu``'s ``.at[idx].set``
    lets the padded slot's stale copy win; see ROADMAP.md §3). On a mesh,
    ``data_n`` is the batch's :class:`_Shards`; the whole batch's result
    comes back from every shard, and the first shard's is applied here.

    Updates ``state`` in place of the old tensors and adds into ``sums``;
    returns ``(cost, beta_object)``, the batch's masked mean cost and its
    LSQML object step (0 for rPIE), as 0-d tensors.
    """
    n_slots = idx_n.shape[0]
    if isinstance(data_n, _Shards):
        result = run_shards(
            data_n.group,
            [
                _batch_steps(
                    plan, device, d, i, m, state, psi_pre, exitwave_options, nb, n_slots
                )
                for device, d, i, m in zip(*data_n[1:])
            ],
        )[0]
    else:
        result = run_local(
            _batch_steps(
                plan, state.psi.device, data_n, idx_n, mask_n, state, psi_pre,
                exitwave_options, nb, n_slots,
            )
        )
    if plan.solver == "lstsq":
        out = result
        costs = out["costs"]
        beta_obj = _lstsq_batch(plan, out, state, sums, idx_n, real_n, recover_now, nb)
    else:
        costs, *nums = result
        _rpie_batch(plan, nums, state, sums, idx_n, psi_pre, probe_pre, recover_now)
        beta_obj = torch.zeros((), dtype=torch.float32, device=state.psi.device)
    cost = torch.sum(costs * mask_n) / torch.clamp(torch.sum(mask_n), min=1)
    return cost, beta_obj


def _position_step(plan: EpochPlan, state: EpochState, pos_num, pos_den, comm=None):
    """The once-per-epoch position update from the summed gradient terms.

    Clip to the magnitude limit, subtract the 5% trimmed mean (no global
    drift), optionally take the AdaM direction, then clamp the positions to
    ``check_allowed_positions``'s window ``[1, dim - P - 1/256]``.

    On a stripe (``comm``) the trimmed mean counts the real positions alone
    and the padded ones do not move; the rows are clamped to the stripe's
    window less 2 rows, and to the global window mapped into the stripe's
    rows (the first stripe's upper halo and the last one's lower halo lie
    outside the object).
    """
    cfg = plan.cfg
    palpha = 0.05
    step = pos_num / (
        (1 - palpha) * pos_den + palpha * torch.clamp(pos_den.max(), min=1e-6)
    )
    limit = plan.pos_update_magnitude_limit
    if limit > 0:
        step = torch.clamp(step, -limit, limit)
    if comm is None:
        step = step - _trim_mean(step, 0.05, dim=0)
    else:
        step = step - _masked_trim_mean(step, comm.pos_mask, 0.05)
        step = step * comm.pos_mask[:, None]
    if plan.pos_use_adaptive_moment:
        step, state.pos_v, state.pos_m = opt.adam(
            step,
            state.pos_v,
            state.pos_m,
            vdecay=plan.pos_vdecay,
            mdecay=plan.pos_mdecay,
        )
    scan = state.scan - step
    lo0, hi0 = 1.0, cfg.nz - cfg.probe_shape - _POS_EDGE
    if comm is not None:
        # The JAX package's float32 arithmetic of the bounds.
        off = np.float32(comm.halo) - np.float32(comm.index) * np.float32(comm.hs)
        lo0 = float(max(np.float32(1.0), np.float32(1.0) + off))
        hi0 = float(
            min(
                np.float32(cfg.nz - cfg.probe_shape - 2.0),
                np.float32(comm.height - cfg.probe_shape - _POS_EDGE) + off,
            )
        )
    state.scan = torch.stack(
        [
            torch.clamp(scan[:, 0], lo0, hi0),
            torch.clamp(scan[:, 1], 1.0, cfg.n - cfg.probe_shape - _POS_EDGE),
        ],
        dim=-1,
    )


def _checked(plan: EpochPlan, state: EpochState, g, which: str, total_e, beta=1.0):
    """The checked momentum on the ``which`` ('obj' or 'probe') moment
    states, ``momentum_checked`` with ``plan.checked_on_host``, else
    ``momentum_checked_traced``; returns the direction and the new
    states."""
    v, m = getattr(state, which + "_v"), getattr(state, which + "_m")
    mdecay = getattr(plan, which + "_mdecay")
    if plan.checked_on_host:
        return opt.momentum_checked(g, v, m, mdecay, state.errors, beta=beta)
    return opt.momentum_checked_traced(
        g, v, m, mdecay, state.err_hist, total_e + 1, beta=beta
    )


def _compact_end(plan, state, sums, beta_obj_mean, psi_pre, probe_pre, recover_now, total_e):
    """Apply the summed updates of a compact epoch, with their checked
    momenta."""
    if plan.solver == "lstsq":
        if plan.recover_psi:
            dpsi = _fz(beta_obj_mean * _precondition_object_update(sums.psi, psi_pre))
            state.psi = state.psi + dpsi
            if plan.obj_moment == "checked":
                d2, state.obj_v, state.obj_m = _checked(
                    plan, state, dpsi, "obj", total_e, beta=beta_obj_mean
                )
                W = torch.abs(psi_pre)
                state.psi = state.psi + _fz((W / (0.1 * W.max() + W)) * d2)
        return
    if plan.recover_psi:
        deno = _rpie_denominator(psi_pre, plan.alpha, (-2, -1))
        state.psi = state.psi + _fz(sums.psi / deno)
        if plan.obj_moment == "checked":
            d2, state.obj_v, state.obj_m = _checked(plan, state, sums.psi, "obj", total_e)
            state.psi = state.psi + _fz(d2 / deno)
    if plan.recover_probe and recover_now:
        ppre = torch.abs(probe_pre[0])
        pdeno = (1 - plan.alpha) * ppre + plan.alpha * ppre.max()
        probe = state.probe + _fz(sums.probe[0] / pdeno)
        if plan.probe_moment == "checked":
            # Mode 0 alone, as in fused.py.
            d2, state.probe_v, state.probe_m = _checked(
                plan, state, sums.probe[0][0, 0, 0], "probe", total_e
            )
            probe = probe.clone()
            probe[0, 0, 0] += d2 / pdeno
        state.probe = probe


def _reconcile_stripes(plan: EpochPlan, state: EpochState, comm: StripeComm):
    """The end of a stripe's epoch, in the JAX package's order: the probe
    (and its moment states) and the eigen probes become their means over
    the stripes weighted by each stripe's real positions (an empty stripe
    weighs 0), then the seams of psi are cross-faded with the neighbours'
    (:func:`~tike_tpu_torch.parallel.halo.cross_fade`). A generator of
    :class:`~tike_tpu_torch.parallel.Sum` and ``Gather`` requests."""
    w = torch.sum(comm.pos_mask)
    means = []
    if plan.recover_probe:
        means.append("probe")
        if plan.probe_moment != "none":
            means += ["probe_v", "probe_m"]
    if plan.has_eigen and state.eigen_probe is not None:
        means.append("eigen_probe")
    total, *sums = yield Sum((w, *(getattr(state, k) * w for k in means)))
    den = torch.clamp(total, min=1.0)
    for k, value in zip(means, sums):
        setattr(state, k, value / den)
    seams = yield Gather(
        torch.stack(
            [state.psi[:, : 2 * comm.halo], state.psi[:, comm.hs : comm.hs + 2 * comm.halo]]
        )[None]
    )
    state.psi = cross_fade(state.psi, seams, comm.index, comm.hs, comm.halo)


def _stripe_rescale_steps(psi, psi_pre, comm: StripeComm):
    """The mean-abs rescale factor of a striped object: the statistics of
    ``remove_object_ambiguity`` over every stripe's interior rows inside
    the object (halo and padding rows are copies or background), summed
    over the stripes, so that all take the same factor."""
    rm = comm.row_mask[None, :, None]
    W = psi_pre.real * rm
    count, wsq = yield Sum(
        (torch.sum(rm) * psi_pre.shape[0] * psi_pre.shape[-1], torch.sum(W * W))
    )
    count = torch.clamp(count, min=1.0)
    Wn = W / torch.clamp(torch.sqrt(wsq / count), min=1e-32)
    weighted = yield Sum(torch.sum(torch.square(torch.abs(psi)) * Wn))
    return 2 * torch.sqrt(weighted / count)


def _epoch_end_steps(
    plan: EpochPlan,
    state: EpochState,
    sums: _Sums,
    beta_obj_mean,
    psi_pre,
    probe_pre,
    recover_now: bool,
    total_e: int,
    nb: int,
    comm: typing.Optional[StripeComm] = None,
):
    """Everything after the batch sweep; updates ``state`` in place of the
    old tensors. ``state.err_hist`` already ends with this epoch's cost.

    A generator that makes no request without ``comm``; on a stripe it
    yields where the stripes are reduced: their reconciliation
    (:func:`_reconcile_stripes`) and the mean-abs rescale. The eigen
    weights of rPIE are normalized over the real positions alone there.
    """
    if plan.recover_positions and total_e >= plan.pos_update_start:
        _position_step(plan, state, sums.pos_num, sums.pos_den, comm)
    if plan.compact:
        _compact_end(
            plan, state, sums, beta_obj_mean, psi_pre, probe_pre, recover_now, total_e
        )
    if (
        plan.solver == "lstsq"
        and plan.recover_probe
        and plan.probe_moment == "checked"
        and recover_now
    ):
        # The mean probe step of the epoch, main mode only, compact or not.
        d2, state.probe_v, state.probe_m = _checked(
            plan, state, sums.pcomb[..., 0, :, :], "probe", total_e,
            beta=sums.pbeta / nb,
        )
        probe = state.probe.clone()
        probe[..., 0, :, :] += d2
        state.probe = probe
    if comm is not None:
        yield from _reconcile_stripes(plan, state, comm)
    if plan.has_eigen and plan.solver == "rpie":
        if comm is None:
            state.eigen_weights = _normalize_eigen_weights(state.eigen_weights)
        else:
            w = state.eigen_weights
            norm = torch.sqrt(
                torch.sum((w * w.conj()).real * comm.pos_mask[:, None, None], dim=-3,
                          keepdim=True)
                / torch.clamp(torch.sum(comm.pos_mask), min=1.0)
            )
            state.eigen_weights = w / (norm + 1e-32)
    if not plan.recover_psi:
        return
    psi = state.psi
    if plan.positivity:
        psi = object_module.positivity_constraint(psi, r=plan.positivity)
    if plan.smoothness:
        psi = object_module.smoothness_constraint(psi, a=plan.smoothness)
    if plan.clip_magnitude:
        psi = object_module.clip_magnitude(psi, a_max=1.0)
    if plan.rescale_mean_abs and (total_e + 1) % plan.rescale_period == 0:
        if comm is None:
            psi, state.probe = object_module.remove_object_ambiguity(
                psi, state.probe, psi_pre
            )
        else:
            scale = yield from _stripe_rescale_steps(psi, psi_pre, comm)
            psi, state.probe = psi / scale, state.probe * scale
    state.psi = psi


def _epoch_end_math(
    plan: EpochPlan,
    state: EpochState,
    sums: _Sums,
    beta_obj_mean,
    psi_pre,
    probe_pre,
    recover_now: bool,
    total_e: int,
    nb: int,
):
    """:func:`_epoch_end_steps` of an epoch on one device or data-parallel
    on a mesh (no stripes)."""
    run_local(
        _epoch_end_steps(
            plan, state, sums, beta_obj_mean, psi_pre, probe_pre, recover_now, total_e, nb
        )
    )


def _start_sums(plan: EpochPlan, state: EpochState) -> _Sums:
    """Zeros for what the plan's batches add up."""
    sums = _Sums()
    if plan.compact:
        sums.psi = torch.zeros_like(state.psi)
        if plan.solver == "rpie":
            sums.probe = torch.zeros(
                (state.psi.shape[0], *state.probe.shape),
                dtype=state.probe.dtype,
                device=state.probe.device,
            )
    if plan.recover_positions:
        sums.pos_num = torch.zeros_like(state.scan)
        sums.pos_den = torch.zeros_like(state.scan)
    if plan.solver == "lstsq" and plan.probe_moment == "checked":
        sums.pcomb = torch.zeros_like(state.probe)
        sums.pbeta = torch.zeros((), dtype=torch.float32, device=state.probe.device)
    return sums


def _sweep(
    plan: EpochPlan,
    batches,
    batch_idx,
    batch_mask,
    batch_real,
    state: EpochState,
    sums: _Sums,
    psi_pre,
    probe_pre,
    exitwave_options,
    recover_now: bool,
):
    """Run :func:`_batch_update_math` on each ``(n, data_n)`` of
    ``batches``, in their order. Returns the (nb,) batch costs in batch
    order and the mean LSQML object step, as device tensors."""
    nb = batch_idx.shape[0]
    costs, betas = [None] * nb, []
    for n, data_n in batches:
        costs[n], beta_obj = _batch_update_math(
            plan,
            data_n,
            batch_idx[n],
            batch_mask[n],
            batch_real[n],
            state,
            sums,
            psi_pre,
            probe_pre,
            exitwave_options,
            recover_now,
            nb,
        )
        betas.append(beta_obj)
    return torch.stack(costs), torch.stack(betas).mean()


def _epoch_steps(
    plan: EpochPlan,
    data,
    batch_idx,
    batch_mask,
    batch_real,
    order,
    state: EpochState,
    exitwave_options,
    total_e: int,
    comm: typing.Optional[StripeComm] = None,
):
    """One full epoch, its batches in ``order``, as a generator.

    data (nb, L, DET, DET) float32, a tensor on the device or host data
    behind a :class:`~tike_tpu_torch.ptycho.stream.StreamedBatches`, which
    copies each batch in while the one before computes, or the
    :class:`ShardedBatches` of a mesh; batch_idx (nb, L)
    int64 and batch_mask (nb, L) float32 on the device; batch_real[n] the int64 slots of
    batch n with a mask above 0; order a sequence of the nb batch numbers.
    Updates ``state`` and returns ``(epoch_cost, pwr)`` as device tensors;
    the epoch cost is the mean of the batch costs taken in batch order.

    Without ``comm`` it makes no request (:func:`_epoch_math` runs it). On
    a stripe of the striped object it yields where the JAX package's
    striped epoch reduces over the stripes: the probe preconditioner is
    summed over them, the epoch cost is the mean over every stripe's real
    slots, and the epoch ends with :func:`_epoch_end_steps`'s requests.
    """
    nb = batch_idx.shape[0]
    recover_now = plan.recover_now(total_e)
    shards = data if isinstance(data, ShardedBatches) else None
    pwr, psi_pre, probe_pre = _epoch_begin_math(
        plan, state, batch_idx, batch_mask, recover_now, total_e, shards
    )
    if comm is not None and probe_pre is not None:
        probe_pre = yield Sum(probe_pre)
    sums = _start_sums(plan, state)
    costs, beta_obj_mean = _sweep(
        plan,
        iter_batches(data, order) if shards is None else shards.batches(order),
        batch_idx,
        batch_mask,
        batch_real,
        state,
        sums,
        psi_pre,
        probe_pre,
        exitwave_options,
        recover_now,
    )
    if comm is None:
        epoch_cost = costs.mean()
    else:
        slots = torch.sum(batch_mask, dim=1)
        num, den = yield Sum((torch.sum(costs * slots), torch.sum(slots)))
        epoch_cost = num / torch.clamp(den, min=1.0)
    if state.err_hist is not None:
        state.err_hist = torch.cat([state.err_hist[1:], epoch_cost.reshape(1)])
    yield from _epoch_end_steps(
        plan,
        state,
        sums,
        beta_obj_mean,
        psi_pre,
        probe_pre,
        recover_now,
        total_e,
        nb,
        comm,
    )
    return epoch_cost, pwr


def _epoch_math(
    plan: EpochPlan,
    data,
    batch_idx,
    batch_mask,
    batch_real,
    order,
    state: EpochState,
    exitwave_options,
    total_e: int,
):
    """:func:`_epoch_steps` of an epoch on one device or data-parallel on
    a mesh (no stripes); returns ``(epoch_cost, pwr)``."""
    return run_local(
        _epoch_steps(
            plan, data, batch_idx, batch_mask, batch_real, order, state,
            exitwave_options, total_e,
        )
    )


def plan_fields(cfg: PtychoConfig, parameters, solver: str, recover_probe: bool) -> dict:
    """The :class:`EpochPlan` fields that follow from the parameters'
    options alone: the solver and its batching, the noise model, what is
    recovered, the position step and the moment kinds of the JAX package
    (rPIE: per-batch AdaM, checked momentum when compact; LSQML: per-batch
    classical momentum for the object, checked when compact, and the
    epoch-end checked momentum for the probe). The probe's moment is kept
    only where ``recover_probe``."""
    p = parameters
    popts, oopts, posopts = p.probe_options, p.object_options, p.position_options
    compact = p.algorithm_options.batch_method == "compact"
    rpie = solver == "rpie"
    obj_moment = "none"
    if oopts is not None and oopts.use_adaptive_moment:
        obj_moment = "checked" if compact else ("adam" if rpie else "momentum")
    probe_moment = "none"
    if recover_probe and popts.use_adaptive_moment:
        probe_moment = "adam" if rpie and not compact else "checked"
    return dict(
        cfg=cfg,
        solver=solver,
        compact=compact,
        noise_model=p.exitwave_options.noise_model,
        steplength_usemodes=p.exitwave_options.step_length_usemodes,
        recover_psi=oopts is not None,
        recover_probe=recover_probe,
        alpha=float(getattr(p.algorithm_options, "alpha", 0.05)),
        has_eigen=p.eigen_weights is not None,
        obj_moment=obj_moment,
        probe_moment=probe_moment,
        obj_vdecay=oopts.vdecay if oopts else 0.999,
        obj_mdecay=oopts.mdecay if oopts else 0.9,
        probe_vdecay=popts.vdecay if popts else 0.999,
        probe_mdecay=popts.mdecay if popts else 0.9,
        recover_positions=posopts is not None and not rpie,
        pos_update_start=posopts.update_start if posopts else 0,
        pos_use_adaptive_moment=posopts.use_adaptive_moment if posopts else False,
        pos_vdecay=posopts.vdecay if posopts else 0.999,
        pos_mdecay=posopts.mdecay if posopts else 0.9,
        pos_update_magnitude_limit=(
            posopts.update_magnitude_limit if posopts else 0.0
        ),
    )


def _preconditioner_of(options, name: str, device):
    """The float32 preconditioner that ``update_preconditioners`` wrote
    into ``options``."""
    if options.preconditioner is None:
        raise ValueError(
            f"{name}.preconditioner is not set; call update_preconditioners "
            "before each epoch"
        )
    pre = torch.as_tensor(options.preconditioner, device=device)
    return (pre.real if pre.is_complex() else pre).to(torch.float32)


def solver_epoch(
    solver: str,
    parameters,
    data,
    batches,
    *,
    op: PtychoConfig,
    epoch: int,
    rng: typing.Optional[np.random.Generator] = None,
):
    """One epoch of ``solver`` ('rpie' or 'lstsq') over all mini-batches:
    the body of the per-epoch functions ``solvers.rpie`` and
    ``solvers.lstsq_grad``.

    ``batches`` is the ``(indices, mask)`` pair of
    ``cluster.batches_padded``; ``data`` holds the patterns batch-major
    (nb, L, DET, DET) or flat (N, DET, DET), as a tensor or a host array
    (copied to the parameters' device). The batches run in order for
    compact batching, else in a permutation drawn from ``rng``. The
    preconditioners are those already in the options
    (``update_preconditioners``), the probe is recovered where
    ``probe_options.recover_probe(epoch)`` says, and no probe or object
    constraint is applied. The epoch's mean batch cost is appended to
    ``algorithm_options.costs`` (read to the host before the epoch-end
    updates, whose checked momenta decide on it), the moment states are
    kept in the options, and ``parameters`` is returned with its fields
    updated.
    """
    rng = np.random.default_rng() if rng is None else rng
    p = parameters
    if solver == "lstsq" and op.nslices != 1:
        raise ValueError("LSQML is single-slice; multislice objects take rPIE")
    device = _device_fields(p)
    algo, oopts, popts, posopts = (
        p.algorithm_options, p.object_options, p.probe_options, p.position_options
    )
    # The probe gate applied here, so the plan recovers it every epoch it
    # recovers it at all; no constraint, no rescale, the checked momenta
    # decided on the host.
    recover_probe = popts is not None and popts.recover_probe(epoch)
    plan = EpochPlan(
        **plan_fields(op, p, solver, recover_probe),
        update_start=0,
        update_period=1,
        rescale_mean_abs=False,
        rescale_period=1,
        checked_on_host=True,
    )
    batch_idx, batch_mask, batch_real = _batch_tensors(batches, device)
    nb = batch_idx.shape[0]
    order = range(nb) if plan.compact else rng.permutation(nb).tolist()
    data = as_tensor(data, torch.float32, device)
    batch_data = (
        ((n, data[n]) for n in order)
        if data.dim() == 4
        else ((n, data[batch_idx[n]]) for n in order)
    )
    if oopts is not None:
        psi_pre = _preconditioner_of(oopts, "object_options", device)
    else:
        psi_pre = torch.ones((1, op.nz, op.n), dtype=torch.float32, device=device)
    probe_pre = None
    if solver == "rpie" and recover_probe:
        probe_pre = _preconditioner_of(popts, "probe_options", device)

    state = EpochState(
        psi=p.psi,
        probe=p.probe,
        scan=p.scan,
        eigen_probe=p.eigen_probe,
        eigen_weights=p.eigen_weights,
    )
    def kept(x):
        return None if x is None else torch.as_tensor(x, device=device)

    if plan.obj_moment != "none":
        state.obj_v, state.obj_m = kept(oopts.v), kept(oopts.m)
    if plan.probe_moment != "none":
        state.probe_v, state.probe_m = kept(popts.v), kept(popts.m)
    if plan.recover_positions and plan.pos_use_adaptive_moment:
        momentum = posopts._momentum
        if momentum is None:
            momentum = torch.zeros((*p.scan.shape[:-1], 4), device=device)
        state.pos_v, state.pos_m = momentum[..., 0:2], momentum[..., 2:4]

    sums = _start_sums(plan, state)
    costs, beta_obj_mean = _sweep(
        plan,
        batch_data,
        batch_idx,
        batch_mask,
        batch_real,
        state,
        sums,
        psi_pre,
        probe_pre,
        p.exitwave_options,
        True,
    )
    algo.costs.append([float(np.mean(to_numpy(costs)))])
    state.errors = [float(c[0]) for c in algo.costs[-3:]]
    _epoch_end_math(
        plan, state, sums, beta_obj_mean, psi_pre, probe_pre, True, epoch, nb
    )

    p.psi, p.probe, p.scan = state.psi, state.probe, state.scan
    p.eigen_probe, p.eigen_weights = state.eigen_probe, state.eigen_weights
    if plan.obj_moment != "none":
        oopts.v, oopts.m = state.obj_v, state.obj_m
    if plan.probe_moment != "none":
        popts.v, popts.m = state.probe_v, state.probe_m
    if plan.recover_positions and plan.pos_use_adaptive_moment:
        posopts._momentum = torch.cat([state.pos_v, state.pos_m], dim=-1)
    return p
