"""The ptychography family: its inputs from the seed, the program's
``Reconstruction`` with its timed call, and the check against the plain
reference in ``reference/ptycho.py``.

Set-up makes every input from the seed: the true object on the device,
and from it and the probe (its modes and eigen state) the diffraction data
by the reference's forward model. The scan is the configuration's own,
one set of positions for every seed, and the program batches it from the
configuration's clustering seed, so every seed gives the same work. Set-up
enters the program's ``Reconstruction`` with the inputs and drives it
through its first calls of the window's own ``iterate(E)``, keeping a host
copy of the program's state after each. Once the window has closed and the
program's state is freed, :meth:`Session.check` works out the batches
itself (``reference/batches.py``), runs the reference over the same epochs
from the same start and compares.
"""

from __future__ import annotations

import math
import time
import typing

import numpy as np
import torch

import tike_tpu_torch.ptycho as tp

from reference import batches as own_batches
from reference import ptycho as ref
import roofline


# ------------------------------------------------------------------ inputs


def true_object(hw: int, gen: torch.Generator) -> torch.Tensor:
    """bench.py's object, a smooth phase and amplitude pattern (1, H, W),
    with its three frequencies (17, 13, 23 in bench.py) and three phases
    drawn from ``gen``: frequencies within 5 of bench.py's."""
    device = gen.device
    f = torch.tensor([17.0, 13.0, 23.0], dtype=torch.float64, device=device)
    f = f + 10 * torch.rand(3, generator=gen, dtype=torch.float64, device=device) - 5
    shift = 2 * math.pi * torch.rand(3, generator=gen, dtype=torch.float64, device=device)
    t = torch.arange(hw, dtype=torch.float64, device=device) / hw
    yy, xx = t[:, None], t[None, :]
    phase = 0.5 * torch.sin(f[0] * yy + shift[0]) * torch.cos(f[1] * xx + shift[1])
    amp = 0.9 + 0.1 * torch.cos(f[2] * xx * yy + shift[2])
    return (amp * torch.exp(1j * phase)).to(torch.complex64)[None]


def scan_positions(config: dict) -> np.ndarray:
    """bench.py's scan: ``n_patterns`` positions uniform in [low, object -
    probe - high_margin) along each axis, rows then columns, from numpy's
    ``default_rng(scan_seed)``; (N, 2) float32."""
    n, p, hw = config["n_patterns"], config["probe"], config["object"]
    low, margin = config["scan"]["low"], config["scan"]["high_margin"]
    rng = np.random.default_rng(config["scan"]["seed"])
    rows = rng.uniform(low, hw - p - margin, n)
    cols = rng.uniform(low, hw - p - margin, n)
    return np.stack([rows, cols], -1).astype(np.float32)


def aperture(p: int, device, rin: float = 0.8, rout: float = 1.0) -> torch.Tensor:
    """A soft-edged circular aperture (P, P) float64, bench.py's probe window."""
    t = torch.arange(p, dtype=torch.float64, device=device) + 0.5
    rs = torch.sqrt((t[:, None] - p / 2) ** 2 + (t[None, :] - p / 2) ** 2)
    rmax = math.sqrt(2) * 0.5 * rout * float(rs.max()) + 1.0
    rmin = math.sqrt(2) * 0.5 * rin * float(rs.max())
    win = torch.clamp((rmax - rs) / (rmax - rmin), 0.0, 1.0)
    win = torch.where(rs < rmin, torch.ones_like(win), win)
    return torch.where(rs > rmax, torch.zeros_like(win), win)


def hermite_modes(probe: torch.Tensor, nmodes: int) -> torch.Tensor:
    """Probe modes from 2-D Cartesian Hermite functions times the probe,
    orthonormalised one after another (Odstrcil et al. 2018), (1, 1, M, P,
    P) complex64; the first mode is the probe, normalised."""
    x = probe[0, 0, 0].to(torch.complex128)
    p = x.shape[-1]
    m_side = int(math.ceil(math.sqrt(nmodes)))
    n_side = int(math.ceil(nmodes / m_side))
    axis = torch.arange(p, dtype=torch.float64, device=x.device) - (p // 2 - 1)
    xx, yy = axis[None, :], axis[:, None]
    p2 = torch.abs(x) ** 2
    tot = p2.sum()
    cx, cy = (xx * p2).sum() / tot, (yy * p2).sum() / tot
    vx, vy = ((xx - cx) ** 2 * p2).sum() / tot, ((yy - cy) ** 2 * p2).sum() / tot
    modes = []
    for n in range(n_side):
        for m in range(m_side):
            basis = (xx - cx) ** m * (yy - cy) ** n * x
            if m or n:
                basis = basis * torch.exp(-((xx - cx) ** 2) / (2 * vx) - ((yy - cy) ** 2) / (2 * vy))
            basis = basis / torch.sqrt(torch.sum(torch.abs(basis) ** 2))
            for h in modes:
                basis = basis - h * torch.sum(h.conj() * basis)
            modes.append(basis / torch.sqrt(torch.sum(torch.abs(basis) ** 2)))
            if len(modes) == nmodes:
                return torch.stack(modes).to(torch.complex64)[None, None]
    raise ValueError(f"no {nmodes} modes")


def make_inputs(config: dict, seed: int, device) -> dict:
    """Every input of a run, on ``device``, from ``seed`` alone: the same
    seed gives the same inputs; every seed the same sizes and positions."""
    n, p, hw, det = config["n_patterns"], config["probe"], config["object"], config["detector"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    scan = torch.as_tensor(scan_positions(config), device=device)
    win = aperture(p, device)
    probe = (win * torch.exp(1j * 0.2 * win)).to(torch.complex64)[None, None, None]
    if config["probe_modes"] > 1:
        probe = hermite_modes(probe, config["probe_modes"])
    psi_true = true_object(hw, gen)
    data = ref.simulate(psi_true[0], scan, probe, det)
    eigen_probe = weights = None
    if config["eigen_probes"]:
        e = config["eigen_probes"]
        eigen_probe = (config["eigen_scale"] * probe[:, :1]).repeat(1, e, 1, 1, 1).contiguous()
        weights = torch.zeros((n, e + 1, probe.shape[2]), dtype=torch.float32, device=device)
        weights[:, 0] = 1.0
    psi = torch.full((1, hw, hw), config["object_start"], dtype=torch.complex64, device=device)
    return dict(scan=scan, probe=probe, psi=psi, eigen_probe=eigen_probe, weights=weights, data=data)


def parameters(inputs: dict, traffic: dict):
    """The program's ``PtychoParameters`` for these inputs and this mix."""
    pos = traffic.get("position_options")
    options = {
        "lsqml": tp.LstsqOptions,
        "rpie": tp.RpieOptions,
    }[traffic["solver"]](num_iter=1, **traffic["options"])
    return tp.PtychoParameters(
        probe=inputs["probe"],
        psi=inputs["psi"],
        scan=inputs["scan"],
        eigen_probe=inputs["eigen_probe"],
        eigen_weights=inputs["weights"],
        algorithm_options=options,
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        position_options=None
        if pos is None
        else tp.PositionOptions(initial_scan=inputs["scan"].cpu().numpy(), **pos),
    )


# ------------------------------------------------------------------ session


class Session:
    """One run's program state: set up by :func:`setup`, driven by
    :meth:`call`, judged by :meth:`check` once :meth:`close` has freed it."""

    def __init__(self, config, traffic, seed, device, limits):
        self.config, self.traffic, self.device = config, traffic, device
        self.limits = limits
        self.epochs_per_call = int(traffic["epochs_per_call"])
        self.parts = {}
        sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

        start = time.perf_counter()
        self.inputs = make_inputs(config, seed, device)
        sync()
        self.parts["inputs_s"] = time.perf_counter() - start

        start = time.perf_counter()
        params = parameters(self.inputs, traffic)
        self.context = tp.Reconstruction(
            self.inputs["data"], params, device=device, random_seed=int(config["cluster_seed"])
        )
        self.context.__enter__()
        sync()
        self.parts["enter_s"] = time.perf_counter() - start
        # The program's own split of its set-up (clustering, data, rescale).
        self.program_parts = dict(getattr(self.context, "setup_seconds", {}))
        # The batches the program chose, in the user's order: judged
        # against the benchmark's own once the window has closed.
        order = np.asarray(self.context.order)
        idx, mask = (np.asarray(a) for a in self.context.batches)
        self.program_batches = [np.sort(order[i[m > 0]]) for i, m in zip(idx, mask)]
        self._batches = None

        # The first steps, through the window's own call; they warm up
        # every shape the window uses.
        start = time.perf_counter()
        self.snapshots = []
        calls = -(-int(traffic["check_epochs"]) // self.epochs_per_call)
        for _ in range(calls):
            self.call()
            sync()
            self.snapshots.append(self._state())
        self.parts["first_calls_s"] = time.perf_counter() - start

    def call(self) -> None:
        """One timed call, ``iterate(E)``; the caller waits for the device."""
        self.context.iterate(self.epochs_per_call)

    def _state(self) -> dict:
        probe, eigen_probe, weights = self.context.get_probe()
        return dict(
            psi=np.array(self.context.get_psi()),
            probe=np.array(probe),
            eigen_probe=None if eigen_probe is None else np.array(eigen_probe),
            weights=None if weights is None else np.array(weights),
            scan=np.array(self.context.get_scan()),
            costs=[float(c[0]) for c in self.context.get_convergence()[0]],
        )

    @property
    def batches(self) -> typing.List[torch.Tensor]:
        """The compact batches as the benchmark works them out from the
        scan and the clustering seed (``reference/batches.py``), on the
        device; the same for every seed of a configuration, so kept once
        a process."""
        if self._batches is None:
            scan = self.inputs["scan"].cpu().numpy()
            key = (scan.tobytes(), int(self.traffic["options"]["num_batch"]), int(self.config["cluster_seed"]))
            if key not in _BATCHES:
                _BATCHES.clear()
                _BATCHES[key] = own_batches.compact(scan, key[1], key[2])
            self._batches = [torch.as_tensor(b, device=self.device) for b in _BATCHES[key]]
        return self._batches

    def patch_bounds(self) -> typing.Dict[str, float]:
        """The least seconds an epoch's patch work needs, by kernel: the
        work the method needs a batch (``patch_work_per_batch``) at each of
        the benchmark's batches' starting positions."""
        psi = self.config["object"]
        work = self.traffic["patch_work_per_batch"]
        out = {}
        for name, count in work.items():
            out[name] = count * sum(
                roofline.patch_bound_s(name, self.inputs["scan"][b], self.config["probe"], (psi, psi))
                for b in self.batches
            )
        return out

    def close(self) -> None:
        """Free the program's state on the device."""
        self.context.__exit__(None, None, None)
        del self.context
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False, fault: typing.Optional[str] = None) -> dict:
        """Follow the set-up's epochs with the reference and compare; see
        :func:`compare`. ``control`` or ``fault`` put the reference, in
        bfloat16 or with the fault planted, in the program's place."""
        program = self.snapshots
        if control or fault:
            program = follow(self, q=ref.bf16 if control else ref.identity, fault=fault)
        start = {k: _host(v) for k, v in _start_state(self, ref.identity).items()}
        numbers = compare(program, follow(self), start, self.limits)
        # The program's batches against the benchmark's: the positions
        # batched elsewhere, or more than once, or not at all.
        n = self.config["n_patterns"]
        bad = 0
        labels = []
        for batches in (self.program_batches, [b.cpu().numpy() for b in self.batches]):
            label = np.full(n, -1)
            for j, b in enumerate(batches):
                bad += int(np.sum(label[b] >= 0))
                label[b] = j
            labels.append(label)
        bad += int(np.sum(labels[0] != labels[1]))
        numbers["schedule_faults"] = {"value": bad, "limit": 0}
        numbers["correct"] = numbers["correct"] and bad == 0
        return numbers


# The benchmark's batches of the last scan it batched, by scan, batch
# count and clustering seed.
_BATCHES: dict = {}


def setup(config, traffic, seed, device, limits) -> Session:
    return Session(config, traffic, seed, device, limits)


def _host(x):
    return None if x is None else x.detach().cpu().numpy()


def _start_state(session: Session, q) -> dict:
    dev = session.device
    inputs = session.inputs
    probe = inputs["probe"] * ref.probe_rescale(inputs["psi"][0], inputs["scan"], inputs["probe"], inputs["data"])
    return dict(
        psi=q(inputs["psi"].clone()),
        probe=q(probe),
        eigen_probe=None if inputs["eigen_probe"] is None else inputs["eigen_probe"].clone(),
        weights=None if inputs["weights"] is None else inputs["weights"].clone(),
        scan=inputs["scan"].clone().to(dev),
    )


def follow(session: Session, q=ref.identity, fault: typing.Optional[str] = None) -> list:
    """The reference over the set-up's epochs, from the inputs, with a
    host copy of its state where the program's was kept."""
    traffic = session.traffic
    pos = traffic.get("position_options") or {}
    state = _start_state(session, q)
    snaps, costs = [], []
    per_call = session.epochs_per_call
    for k in range(len(session.snapshots) * per_call):
        if traffic["solver"] == "rpie":
            new, cost = ref.rpie_epoch(
                state,
                session.inputs["data"],
                session.batches,
                alpha=float(traffic["options"].get("alpha", 0.05)),
                q=q,
                drop_half=fault == "half_batch",
            )
        else:
            new, cost = ref.lsqml_epoch(
                state,
                session.inputs["data"],
                session.batches,
                positions=traffic.get("position_options") is not None,
                position_limit=float(pos.get("update_magnitude_limit", 0.0)),
                q=q,
                drop_half=fault == "half_batch",
            )
        if fault != "unchanged":
            state = new
        costs.append(cost)
        if (k + 1) % per_call == 0:
            snap = {key: _host(v) for key, v in state.items()}
            if fault == "altered":
                snap["psi"] = snap["psi"].copy()
                h, w = snap["psi"].shape[-2:]
                snap["psi"][0, h // 2, w // 2] = 0
            snap["costs"] = list(costs)
            snaps.append(snap)
    return snaps


LEAVES = ("psi", "probe", "eigen_probe", "weights", "scan")


def compare(program: list, reference: list, start: dict, limits: dict) -> dict:
    """The numbers compared, each with its limit.

    ``cost_gap``: the largest relative gap between the program's cost of an
    epoch and the reference's. ``state_gap``: over every kept state and
    every leaf (object, probe, eigen probes, eigen weights, positions), the
    largest gap of an element between program and reference, over the
    largest change of an element of that leaf from the start in the
    reference; ``detail`` holds that gap leaf by leaf.

    A leaf that the reference has moved by round-off alone, less than a
    thousandth of the median leaf's change relative to its own size, is
    left out of that state (listed under ``left_out``): the positions after
    the first epoch from a constant object, whose gradient is nought to
    rounding, move by some thousandths of a pixel, and one float32 step of
    a position would read as a gap of several percent.
    """
    cost_gap, state_gap, worst = 0.0, 0.0, ""
    detail, left_out = {}, []
    for k, (got, want) in enumerate(zip(program, reference)):
        for c_got, c_want in zip(got["costs"], want["costs"]):
            gap = abs(c_got - c_want) / abs(c_want) if math.isfinite(c_got) else math.inf
            cost_gap = max(cost_gap, gap)
        moved, relative = {}, {}
        for leaf in LEAVES:
            if want.get(leaf) is None:
                continue
            w = want[leaf].astype(np.complex128 if np.iscomplexobj(want[leaf]) else np.float64)
            moved[leaf] = float(np.max(np.abs(w - start[leaf])))
            relative[leaf] = moved[leaf] / max(float(np.max(np.abs(start[leaf]))), 1e-30)
        floor = 1e-3 * float(np.median(list(relative.values())))
        for leaf in moved:
            if moved[leaf] == 0 or relative[leaf] < floor:
                left_out.append(f"{leaf}@call{k + 1}")
                continue
            w = want[leaf].astype(np.complex128 if np.iscomplexobj(want[leaf]) else np.float64)
            diff = np.abs(got[leaf] - w)
            gap = float(np.max(diff)) / moved[leaf] if np.all(np.isfinite(diff)) else math.inf
            detail[leaf] = max(detail.get(leaf, 0.0), gap)
            if gap > state_gap:
                state_gap, worst = gap, f"{leaf}@call{k + 1}"
    numbers = {
        "cost_gap": {"value": cost_gap, "limit": limits["cost_gap"]},
        "state_gap": {"value": state_gap, "limit": limits["state_gap"], "worst": worst},
    }
    numbers["correct"] = all(v["value"] <= v["limit"] for v in numbers.values() if isinstance(v, dict))
    numbers["detail"] = dict(detail, left_out=left_out)
    return numbers
