#!/usr/bin/env python3
"""Drive the PyTorch port (tike_tpu_torch) once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``), and imports nothing
of JAX. Phases, in order; any failure raises and the script exits non-zero
without printing the final ``ok`` line:

1. environment: torch, CUDA, card, power limit and nvcc versions;
2. build: compile ``tike_tpu_torch/csrc/patch.cu``, ``usfft.cu``,
   ``usfft_gaussian.cu`` (the Gaussian window's kernels),
   ``probe.cu``, ``bucket.cu``, ``bucket_first_form.cu`` (the Bucket
   kernels' first form, a yardstick), ``interp.cu`` and
   ``interp_first_form.cu`` (the Lanczos kernels' first form) for sm_90a, and ``probe.cu`` with its
   gridded and prefetch kernels in their parent's form
   (``kernel_sweep.parent_form``), one nvcc each, all started together;
3. kernel parity at the main path's shapes (1500^2 complex object, 1,000
   positions, P=128, some windows past the bottom/right edges): each CUDA
   kernel against its plain PyTorch version, two launches of each on the
   same inputs bitwise equal, and the edge cases of
   ``tests/_torch_patch_cases.py`` (negative corners, windows wholly
   outside the image, N = 0 and 1, P = 100, an odd P, float32 with an odd
   W, 5,000 windows on one tile), and the positions of one compact batch
   of the main path; times of each kernel, its plain version and one
   PyTorch call that computes the same function (``grid_sample`` and its
   input gradient), from CUDA events, beside the kernel's bound for those
   positions (the bytes they need at the card's HBM rate), and the
   kernel's and the library call's on the compact batch beside its own
   bound;
4. forward model: the port's ``simulate`` on the card against a numpy
   forward model (the math of ``bench.py``'s ``_simulate_numpy``) on 256
   positions, with one probe mode, 3 modes, and 3 modes with an eigen
   probe and per-position weights;
5. small slices: 3-epoch LSQML reconstructions on the card against the
   port's plain-PyTorch path on the CPU, on the same seeded input: one
   probe mode, then config 2's features (3 modes, eigen probe and weights,
   position correction);
6. main path: 10,000 simulated 128^2 patterns of a 1500^2 object, LSQML
   with compact batching (num_batch=10), ``iterate(1)`` then a timed
   ``iterate(3)``, every kernel count set to 0 just before it and read
   just after (phases 7, 8 and 18b alike); costs must be finite and
   decreasing, and both patch kernels must have been launched by it;
7. config 2 (``bench_all.py``'s ``lsqml_opr_pos``, BASELINE.md config 2):
   the same scan and object with 3 probe modes, one eigen probe with
   per-position weights and position correction, data simulated on the
   card; ``iterate(1)`` then a timed ``iterate(3)``; costs finite and
   decreasing, both patch kernels launched, eigen probe and weights
   finite and moved, positions moved inside the allowed window and by at
   most twice the update limit per epoch;
8. rPIE at full width (BASELINE.md config 1's solver): the same scan and
   object with 3 probe modes, ``RpieOptions(num_batch=5)`` (wobbly-center
   batches, alpha 0.05), object AdaM and magnitude clipping, probe
   orthogonalization, centering and AdaM; ``iterate(1)`` then a timed
   ``iterate(3)``; costs finite and decreasing, both patch kernels
   launched, the mode powers in descending order after each
   orthogonalization, and ``|psi| <= 1``;
9. rPIE on the measured siemens-star data (``bench_all.py``'s
   ``rpie_siemens``: 516 patterns of 128^2, ``num_batch=5``, compact),
   3 epochs on the card against the port's CPU path, costs finite and
   decreasing.

Phase 5 also runs two more small slices card against CPU (5c): rPIE with
wobbly-center batches, 3 modes, an eigen probe and weights, every probe
constraint, the object smoothness and positivity constraints, object and
probe AdaM and ``constant_probe_photons``; and one-mode LSQML with Poisson
noise and wobbly-center batches.

Phase 3 is followed by the KB kernels' parity (3b): ``kb_gather`` and
``kb_scatter`` against their plain versions and against adjointness
(<gather(G), f> = <G, scatter(f)>) on laminography's points at
``bench_all.py``'s 128^3 / 64 angles (upsample 1, m = 1; upsample 2, a
256^3 grid, m = 2), on flat random points of which a third wrap (m = 1, 2,
4 and 7) and on a 256^3 / 128-angle transform (8,388,608 points); two
launches of each kernel on one geometry plan, and a third that builds its
own, bitwise equal on every case; times (the plan's build; a CUDA graph of
the kernel's launches on a plan built beforehand; eager calls with that
plan and building their own) beside each bound and the plain version's,
and at 128^3 / 64 angles the einsum chain of ``tike_tpu``'s
``gather_kb_rows``/``scatter_kb_rows`` as the yardstick.

After phase 9:

10. a laminography slice, card against CPU: ``simulate``, then cgrad and
    CGLS, 3 outer iterations on a 16^3 volume at 8 angles, upsample 2;
11. laminography at full width (``bench_all.py``'s ``lamino_cgrad`` and
    ``lamino_cgls``: a 128^3 volume, 64 angles, tilt pi/3, eps 1e-3,
    upsample 1, ``cg_iter=4``): ``simulate`` on the card against the CPU,
    then for each solver one warm-up outer iteration and 5 timed ones, with
    the kernel counts set to 0 before and read after; costs finite and
    decreasing, both KB kernels launched; s/iteration (and that of two more
    timed runs, for the spread), set-up, peak memory and the line search's
    host reads; then the warm-up once more from the same start, whose cost
    and volume must equal the first one's bit for bit;
12. the seven feature probes (``tike_tpu_torch/toolchain_probe.py``): each
    launched once on ``arange``-valued inputs and equal to its plain
    version bit for bit, the element windows also at every lead (``cx %
    4``) at ``big``'s edges, gridded and prefetch also at odd shapes and
    index arrays (``tests/_torch_probe_cases.py``), then timed beside its
    bound: in a CUDA graph with the index check left out (the kernel's own
    time), in turns with the launch floor (``csrc/probe.cu``'s empty kernel
    at the probe's grid), the library call (two calls for ``prefetch``) and,
    for gridded and prefetch, the kernel in its parent's form; and as an
    eager call with the index check, beside the plain version and the
    library call.

After phase 12, the joint-ADMM and host-streamed paths:

3c. (with phase 3) both patch kernels against their plain versions, two
    launches bitwise equal, at the two new paths' shapes: 200 windows of
    16^2 on a 64^2 image (complex64, and float32 as the ADMM coverage
    weights spread it) and one streamed batch of 10,000 windows of 64^2 on
    4096^2; each kernel's time beside its bound there;
3d. (with phase 3) the far-field kernel of the Gaussian model
    (``csrc/farplane.cu``) against its plain version (the solvers' ATen
    chain) on every case of ``tests/_torch_farplane_cases.py`` and at the
    main path's 1,000 x 128^2 with 1 and 3 modes, chi written over the
    farplane and two launches bitwise equal; its time at those shapes, every
    pixel measured, beside the plain chain's and the bound its bytes set.
    Phases 6, 7, 8, 18b and 21b check that their timed epochs launched it
    once a batch (on a mesh, once a batch and shard);
13. small slices, card against CPU: a streamed rPIE and a streamed LSQML
    run (``store_data_on_device=False``) equal bit for bit to the resident
    run on the card and equal to the CPU's streamed run at phase 5's
    tolerance; a ``convergence_window`` run and a ``time_limit`` run that
    stop after the same epoch on the card as on the CPU; one joint-ADMM
    iteration (n = 16, 3 angles) card against CPU;
14. ``admm_joint`` at ``bench_all.py``'s size (n = 64, P = 16, 8 angles, 200
    positions per angle, rPIE ``num_batch=1``, ``ptycho_iter=2``,
    ``lamino_iter=2``, upsample 2): one warm-up iteration, then three timed
    runs of 3 iterations from the warm-up's result, the kernel counts set
    to 0 before the first and read after it; s/iteration, set-up, peak
    memory, finite and decreasing costs, the three runs bitwise equal, one
    ``LaminoPlan`` built per call;
15. ``stream_1m`` at ``bench_all.py``'s size (1,000,000 x 64^2 float32
    patterns in pinned host memory, a 4096^2 object, rPIE,
    ``num_batch=100``, ``batch_method="random"``, seed 0, the probe rescaled
    from the streamed data at set-up, one epoch): patterns/s, s/epoch,
    set-up split into clustering, pinning and rescale, peak device memory
    (it fails above 4 GB), a finite cost, and the overlap: the copy
    stream's busy time and the compute stream's wait on it. A host that
    cannot pin the data makes the phase halve the number of patterns and
    say so; nothing is copied from pageable memory. Then
    ``bench_all.py``'s comparison at 100,000 patterns (``num_batch=10``):
    resident against streamed s/epoch, and their results bitwise equal.

After phase 15, Bucket laminography and the rest of ptychography:

16. the Bucket kernels (``csrc/bucket.cu``): each against its plain
    version (the forward to its atomics' rounding, the adjoint bit for bit),
    adjointness, two adjoint launches bitwise equal, the points per cell of
    a volume of ones equal, and every point's cell equal to the plain
    version's (``tests/_torch_bucket_cases.py::cell_mismatches``) and no
    point outside its tile's window (the card's counter, 0) at n = 16
    with precision 1, 2 and 4, at the golden geometry of
    ``tests/data/lamino_setup.pickle.lzma`` (64^3, 58 angles, precision 1)
    and at bench_all.py's 128^3 with precision 3 at one angle and at all 64;
    each kernel's time in a CUDA graph in turns with its first form's
    (``csrc/bucket_first_form.cu``), eager and plain, beside its bound
    counted pipe by pipe (bytes, FP32 instructions, floors) and the first
    count's, at the full-width and golden shapes; the reference's golden protocol (1 +
    30 outer iterations at eps=1) against ``lamino_bucket.pickle.lzma`` at
    atol 1e-3; then ``bucket.simulate`` and ``bucket.reconstruct`` at
    bench_all.py's laminography geometry (128^3, 64 angles in [0, pi), tilt
    pi/3) with eps 1e-1 (precision 3) and ``cg_iter=4``: one warm-up outer
    iteration and 5 timed, the kernel counts set to 0 before the timed run
    and read after it; s/iteration, set-up, peak memory, finite and
    decreasing costs, both kernels launched, no point outside its window;
17. ``reconstruct_multigrid`` at the main path's configuration (3 levels of
    32^2, 64^2 and 128^2 patterns, 2 epochs each, seed 0): each level's
    set-up, s/epoch, costs and patch launches, the final cost; then at
    small sizes: config 2 with a finite ``time_limit`` (eigen probes on the
    per-epoch path) card against CPU, a checkpoint written on the card,
    loaded and resumed against 4 epochs at once, ``append_new_data`` card
    against CPU, ``update_positions_pd`` card against CPU, and ``simulate``
    with ``fly=3`` against numpy.

After phase 17, multislice ptychography and alignment:

18. multislice rPIE: (a) the reference test's problem
    (``tests/ptycho/test_multislice_recon.py``: 2 slices of 96^2, 120
    positions of a 16^2 probe, wavelength 1.4e-10 m, field of view 1e-6 m,
    slices 2e-8 m apart), ``simulate`` on the card against the CPU, then 3
    rPIE epochs card against CPU; (b) the main path's data and geometry
    (10,000 x 128^2, a 1500^2 frame, compact, ``num_batch=10``, one mode)
    through 3 slices with the same optics, data simulated on the card:
    ``iterate(1)`` then a timed ``iterate(3)`` with the kernel counts set to
    0 before and read after, one epoch traced (idle share, the patch
    kernels' and cuFFT's launches and time), then the same run with one
    slice for the comparison; costs finite and decreasing;
19. alignment: (a) the Lanczos remap kernels (``csrc/interp.cu``) against
    their plain versions and their adjointness on the cases of
    ``tests/_torch_interp_cases.py`` (m 0, 1, 2, 5, 11; complex and real; a
    complex cval; points outside, on the edges and on integers; shared
    points) and at 128 x 1024^2 (the flow warp's and the rotation's points)
    and 1 x 128^2, there also against their first form
    (``csrc/interp_first_form.cu``) with the adjoint's fallback warps
    counted, then timed in CUDA graphs in turns with their first form,
    their plain versions and bicubic ``grid_sample`` (its input gradient
    for the adjoint), beside their bounds; (b) ``align.simulate`` of the golden
    dataset (``tests/data/algin_setup.pickle.lzma``) at atol 1e-6; (c) at
    128 x 1024^2 complex64: ``simulate`` with a smooth flow, shifts of up to
    8 px and a 0.05 rad rotation, ``invert``, ``reconstruct`` by
    cross-correlation at upsample 10 on a shifted stack (every shift within
    0.15 px), and the operator's adjoint held by adjointness, the kernel
    counts set to 0 before and read after; Farneback is not run (OpenCV on
    the host; the card's machine has no ``cv2``).

After phase 19, the rest of the public API by hand:

20. (a) a zone-plate start: ``fresnel.single_probe`` at 128^2 with the
    optics of the original tike's fresnel test, 3 Hermite modes, their
    powers set by ``adjust_probe_power`` on the card (against the CPU),
    ``MW_probe`` at 3 energies (modes sorted by power) and
    ``simulate_varying_weights``; (b) the reference's per-epoch loop
    written by hand at the main path's configuration (phase 6's scan,
    object and probe, data simulated on the card, one compact clustering
    of the 10,000 positions into 10 batches, timed on the host, the probe
    rescaled to the data as ``Reconstruction``'s set-up does): 1 + 3 epochs of
    ``update_preconditioners`` then ``solvers.lstsq_grad``, then 1 + 3 of
    ``update_preconditioners`` then ``solvers.rpie`` on the same batches,
    each solver's kernel counts set to 0 before its 3 timed epochs and read
    after; costs finite and decreasing, both patch kernels launched, each
    solver's s/epoch beside phase 6's ``iterate``; (c) the same loop at
    phase 5's small size, card against CPU at phase 5's tolerance (LSQML
    with compact batches, batch-major data and position correction; rPIE
    with wobbly-center batches and flat data); (d) ``remove_object_ambiguity``
    of (b)'s LSQML object, ``learn.extract_patches`` at all 10,000 positions
    of the 1500^2 object against ``patch_fwd_plain`` on the card,
    ``patch_fwd_padded`` to 256^2, the Fourier patch pair's adjointness
    and its plain path on 1,000 windows on the card, and
    ``get_absorbtion_image`` of the 10,000 patterns (a host time).

After phase 20, the mesh (``tike_tpu_torch.parallel``) on the one card:

21. (a) phase 5's LSQML slice on a mesh of two shards, both on the card,
    against the same mesh on the CPU at phase 5's tolerance, and a
    one-shard mesh against no mesh, bit for bit; (b) the main path on two
    shards: its costs, each patch kernel launched twice as often as in
    phase 6 (once a shard), s/epoch, set-up and peak memory beside phase
    6's, one traced epoch, and the final cost, psi and probe against phase
    6's (``MESH_PSI_TOL``, ``MESH_PROBE_TOL``); (c) phase 11's cgrad with
    the angles over two shards, costs within ``MESH_LAMINO_RTOL`` of phase
    11's, s/iteration beside it; (d) the tiled Bucket kernels on the two
    64-row x-slabs of 128^3 / 64 angles / precision 3 against their plain
    versions (no point outside its window; the slabs' forwards summed
    within the rounding bound of the full lattice's), their times beside
    the full lattice's per voxel; ``obj_split=2`` at phase 16's problem,
    s/iteration beside phase 16's; and the golden protocol on a 2 x 2 (data
    x volume) mesh; (e) host streaming on the mesh: phase 5's slice
    streamed on two card shards against the same mesh resident (on the
    per-epoch path both), bit for bit, and the main path streamed on two
    shards from host data, s/epoch, set-up, peak memory and the copy
    stream's busy and wait times beside 21b's, the final psi and probe
    against phase 6's (``MESH_PSI_TOL``, ``MESH_PROBE_TOL``).

22. The striped object (``object_sharding="striped"``) on two stripes,
    both on the card: (a) ``tests/_torch_striped_cases.py``'s 160^2 LSQML
    problem, 3 epochs on the card against the same stripes on the CPU at
    phase 5's tolerance, and streamed against resident on the card, bit
    for bit; (b) the main path's LSQML (10,000 x 128^2, 1500^2,
    ``num_batch=10``, compact, seeded) striped: hs = 750, halo = 137,
    windows of 1024 x 1500; iterate(1) then a timed iterate(3) with every
    kernel count set to 0 just before it, s/epoch, set-up, peak memory and
    patch launches, and one more epoch traced; its psi against phase 6's replicated result by the
    interior correlation of ``tests/parallel/test_striped.py`` (> 0.95) and
    its final cost within that test's factor; then the same configuration
    host-streamed (its psi against the resident stripes' at phase 5's
    tolerance, the final cost too) and rPIE resident; (c) the halo
    cross-fade's time at the windows' shape.

23. Two processes (``tike_tpu_torch.parallel.distributed``): the script
    starts two workers of itself (``--worker``), each a gloo rank with one
    shard on ``cuda:0`` (NCCL refuses two ranks on one card), after the
    kernels were built and after it ran the one-process references; a
    worker that fails or hangs fails the phase. (a) phase 5's slice in the
    multi-process layout, each process from its ``stripe_for_process``
    rows, the ranks bit for bit equal and against one process's
    ``_force_stripes=2`` run on two shards of the card (held at 1e-6); (b)
    the main path at full width, each rank holding its 5,000 patterns on
    the host: s/epoch, set-up, peak memory, the collectives' calls, ms and
    bytes an epoch a rank, beside 21b's and the one-process layout's
    s/epoch, the ranks bit for bit equal and psi within 1e-5 of the
    one-process ``_force_stripes=2`` run; (c) the striped object, one stripe
    a process, each from its ``striped_local_indices`` rows, against 22b's
    two stripes in one process; (d) phase 11's cgrad with 32 of the 64
    angles a process, its costs against 21c's, and phase 16's Bucket
    problem with a 64-row slab a process, on projections the parent
    simulated: timed beside 21d, and at cg_iter 1 against the parent's
    one-process run on the same projections (from cg_iter 3 the solver's
    costs on the card differ from run to run, ROADMAP.md section 3); then
    25d's cgrad with the Gaussian window, the ranks bit for bit equal, its
    costs held in 25d against the same split in one process.

24. The examples and scripts (``examples/torch/``, ``scripts/torch/``),
    each loaded by path and run on ``cuda:0`` with every kernel count set
    to 0 just before it and read just after; a run in which a kernel that
    the example runs was launched no time fails. (a) Each of the five
    examples at its own size, checked as the JAX example checks it (scan:
    every series finite; align: the shift error; lamino: costs finite and
    falling, the relative error; ptycho: both stages' costs finite and
    falling; admm: its own ``corr > 0.5`` and falling costs), then at a
    small size (``tests/_torch_examples_cases.py``) on the card and on
    the CPU path, held together as the earlier phases hold small slices;
    (b) ``admm_quality`` with the cube (24 iterations, rho 2) and the blobs
    (12, rho 0.5), which must reach ``tests/test_admm_quality.py``'s
    pinned 0.88 and 0.93, their ceilings printed; (c) the striped demo at
    4096^2 on ``make_mesh()`` and on ``[cuda:0, cuda:0]`` (interior
    correlation, window, s/epoch), then the long-axis demo at 100,000
    patterns (a cut: phase 15 runs the same streamed path at 1,000,000).
    Each run's seconds are logged beside the card's name.

25. The Gaussian window (``kernel="gaussian"``, the original tike's only
    window) through ``csrc/usfft_gaussian.cu`` on Gaussian plans, at
    bench_all.py's laminography geometry (128^3, 64 angles, tilt pi/3, eps
    1e-3): (a) the gather and scatter at upsample 1 (m = 2) and 2 (m = 4)
    against their plain versions at 1e-5 of the largest value and against
    their first form (the KB kernels of ``csrc/usfft.cu`` on the same plan,
    their yardstick), adjointness, three launches of each bitwise equal;
    their times in CUDA graphs in turns with the first form and the KB
    kernel at the same upsample, the plain version's, the plan's ms and
    bytes, and the bound pipe by pipe (bytes at 3.35 TB/s, FP32
    instructions at 33.45e12 a second); (b) ``reconstruct(kernel=
    "gaussian")`` on phase 11's problem: cgrad at cg_iter 4, one warm-up
    and 5 timed outer iterations with every kernel count set to 0 before
    and read after, s/iteration beside phase 11's KB run, costs falling,
    the Gaussian kernels' launches equal to what the iterations and the
    line search's trials predict and the KB kernels' 0; then CGLS at
    cg_iter 1, 5 outer iterations, 10 launches of each; (c) phase 10's
    slice with the Gaussian window at upsample 1 and 2, card against CPU
    (at upsample 1 CGLS at cg_iter 4 for one outer iteration and at cg_iter
    1 for three: ``GAUSSIAN_SLICE_RUNS``), and, for the record, CGLS at
    cg_iter 4 for three outer iterations at upsample 1 on the card and on
    the CPU in the plain version's, the first form's and the kernels'
    order and on data changed by 1e-7, each pair's distance logged;
    (d) cgrad at cg_iter 1 with the angles over ``[cuda:0, cuda:0]``
    against one device, and phase 23's two processes against it.

26. Grids past 2^31 cells and the Gaussian window above m = 16: (a) both
    windows' gather and scatter on laminography's 26,708,224 points of a
    646^3 volume, 64 angles, tilt pi/3, eps 1e-3, upsample 2 (a 1292^3
    grid, 2,156,689,088 cells; KB m = 2, Gaussian m = 4), checked against
    the plain versions on 65,536 of the points and 8,192 points in cells
    past the 2^31-th (the scatter's grid compared 64 planes at a time),
    three launches of each bitwise equal and adjointness there, the times
    on all the points (the gather in a CUDA graph, the scatter by CUDA events) beside
    the bound pipe by pipe, the plain versions' once, the plan's ms and
    bytes and the peak memory; (b) the Gaussian pair at upsample 3 / eps
    1e-10, 4 / 1e-8 and 4 / 1e-10 (m = 17, 18, 22) on phase 25a's points,
    against the plain versions on 16,384 of them, adjointness and repeats
    there, times on all of them beside the first form's gather (a thread a
    point) and the bound; (c) ``reconstruct`` at 646^3, 64 angles, upsample 2,
    cgrad at cg_iter 2 with both windows (one warm-up outer iteration, then
    two timed), with the memory of its stages (plans, a forward, an
    adjoint) and its peak, or, where it does not fit, where the memory went
    until then; and a slice at upsample 4, eps 1e-8 (m = 18) with
    the Gaussian window on a 10^3 volume and 4 angles, card against CPU.

The line before the last lists each kernel (its launches in phase 14's
first timed run as ``launches_admm`` and in phase 15's epoch as
``launches_stream``, in phase 16's timed run as ``launches_bucket`` and,
for the patch kernels, in phase 17's levels as ``launches_multigrid_32``,
``_64`` and ``_128``; the Bucket kernels' ``launches`` are phase 16's, with
their points, the sum of the out-of-window counter's readings
(``outside_windows``), their first form's time
``parent_form_ms`` and their bound pipe by pipe (``bound_fp32_ms``,
``bound_floors_ms``, ``bound_bytes_ms``) beside the first count's
``bound_ms_first_count``, at the full-width and ``_golden`` shapes; the
Lanczos kernels' first form's times ``first_form_ms`` (``_rotate``,
``_golden``), the forward's time at m = 11 on the flow's points
``ms_m11`` and the adjoint's fallback warps ``fallback_warps`` (the same
suffixes); its
launches in phase 6 as
``launches``, in phase 7 as ``launches_config2`` and in phase 8 as
``launches_rpie``; the KB kernels' in phase 11's cgrad as ``launches`` and
``launches_lamino_cgrad`` and in its CGLS as ``launches_lamino_cgls``; the
probes' in phase 12, the Lanczos kernels' in phase 19c; every kernel's
launches in phase 18b's timed run as ``launches_multislice``, in 19c as
``launches_align``, in phase 20b's timed epochs of both solvers as
``launches_api``, on phase 21's mesh as ``launches_mesh``: 21b's for the
patch kernels, 21c's for the KB kernels, 21d's ``obj_split=2`` for the
Bucket kernels, in 21e's streamed main path as ``launches_mesh_stream`` and
in 22b's striped LSQML, its streamed run and its rPIE as
``launches_striped``, ``launches_striped_stream`` and
``launches_striped_rpie``, in phase 24's runs of the examples and scripts
at their own sizes as ``launches_examples_<name>``, and in phase 23's timed runs as
``launches_distributed_main``, ``_striped``, ``_lamino``, ``_bucket`` and
``_lamino_gaussian``,
a list of one count a rank, each the count that rank read in that run;
the far-field kernel ``farplane_gaussian`` gives the patch kernels' launch
counts (phase 6's as ``launches``, 7's, 8's and the later runs') and 3d's
times at 1 mode (``ms``, ``plain_ms`` for the plain ATen chain,
``bound_bytes``, ``bound_ms``, ``roofline_share``) and, suffixed
``_modes_3``, at 3 modes, with the largest gaps over 3d's cases
(``max_cost_gap``, ``max_chi_gap``);
the Bucket kernels' slab times come as ``ms_slab0`` / ``ms_slab1`` with
their bounds; the Gaussian pair, ``usfft_gather_gaussian`` and
``usfft_scatter_gaussian``, lists 25b's cgrad launches as ``launches`` and
``launches_lamino_gaussian_cgrad``, its CGLS run's as
``launches_lamino_gaussian_cgls`` and 25d's as ``launches_gaussian_mesh``,
25a's times at upsample 1 and, suffixed ``_upsample2``, at upsample 2,
with the first form's beside them as ``first_form_ms`` (its difference as
``first_form_err``), the KB kernel's as ``kb_ms`` and the bound pipe by pipe
as ``bound_bytes_ms`` and ``bound_fp32_ms``); both windows' kernels give
26a's numbers suffixed ``_n1292`` and 26c's launches as
``launches_lamino_646``, the Gaussian pair 26b's suffixed ``_m17``,
``_m18`` and ``_m22``, and ``usfft_gather_gaussian_wide`` (the gather's
form above 32 taps) 26c's slice launches at m = 18 as ``launches`` and
26b's m = 17 numbers as its own; its error against the plain version, its time, the
plain version's and the library call's, its bound in bytes and ms and its
share of that bound, the same on the compact batch, whether it is
deterministic; each probe's launch floor ``floor_ms``, for gridded and
prefetch the parent's form's time ``parent_form_ms``, and for prefetch,
which no single call computes, ``library_ms`` null beside
``library_two_calls_ms``); each full-width path also logs each kernel's bound per
launch over its batches. The last line is
``{"ok": true, "device": {...}}``.
"""

import bz2
import contextlib
import functools
import importlib.metadata
import json
import lzma
import os
import pickle
import statistics
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import tike_tpu_torch.admm as tadmm
import tike_tpu_torch.align as talign
import tike_tpu_torch.lamino as tl
import tike_tpu_torch.lamino.bucket as tlb
import tike_tpu_torch.ptycho as tp
import tike_tpu_torch.ptycho.ptycho as tpp
from tests import _torch_bucket_cases as cases_bucket
from tests import _torch_examples_cases as cases_examples
from tests import _torch_farplane_cases as cases_farplane
from tests import _torch_interp_cases as cases_interp
from tests import _torch_patch_cases as cases
from tests import _torch_probe_cases as cases_probe
from tests import _torch_striped_cases as cases_striped
from tests import _torch_usfft_cases as cases_usfft
from tike_tpu_torch import (
    checkpoint, cluster, convert, kernel_sweep, kernels, linalg, opt, parallel, profile_epoch,
    toolchain_probe,
)
from tike_tpu_torch.constants import wavenumber
from tike_tpu_torch.ops import alignment as ops_alignment
from tike_tpu_torch.ops import bucket, interp, objective, patch, shift, usfft
from tike_tpu_torch.ops import lamino as ops_lamino
from tike_tpu_torch.ops.lamino import LaminoPlan
from tike_tpu_torch.ops.ptycho import PtychoConfig
from tike_tpu_torch.parallel import distributed
from tike_tpu_torch.parallel import halo as parallel_halo
from tike_tpu_torch.parallel import striped as parallel_striped
from tike_tpu_torch.ptycho import learn

# The main path's configuration (bench.py: 10,000 x 128^2 from a 1500^2
# object, LSQML, num_batch=10, compact batches).
N_PATTERNS, DET, PROBE, HW, NUM_BATCH = 10_000, 128, 128, 1500, 10
BATCH = N_PATTERNS // NUM_BATCH

# simulate vs numpy: float32 FFTs from two libraries; near-zero far-field
# pixels get an absolute floor relative to the largest intensity.
SIM_RTOL, SIM_ATOL = 1e-4, 1e-6
# Small slice, card vs CPU: the card's kernels, cuFFT and reductions sum in
# other orders than the CPU's plain versions, and 3 epochs of LSQML carry
# that rounding forward.
SLICE_TOL = 1e-4
# The same for positions, in pixels: the position step divides the summed
# gradient terms by their own magnitudes, which carries their rounding.
SLICE_SCAN_TOL = 1e-3
# Config 2 (bench_all.py:134-176): 3 probe modes, one eigen probe,
# position correction with this per-epoch update limit (pixels).
MODES, POS_LIMIT = 3, 2.0
# rPIE at full width: RpieOptions' own default number of batches, and the
# photon count of the probe's modes together. Non-compact rPIE with object
# AdaM adds a scale-free step divided by the illumination (ROADMAP.md
# section 3), so the unit-scale model of phases 6 and 7 (under one photon
# per detector pixel) blows the object up; the probe is scaled to counts
# like measured data's instead.
RPIE_NUM_BATCH, RPIE_PHOTONS = 5, 1e7
# The rPIE slice's data and probe are this much brighter than the model's
# (intensity x BRIGHT^2): non-compact rPIE with object AdaM adds a
# scale-free step divided by the illumination, and at the model's own
# brightness the object blows up (ROADMAP.md section 3).
BRIGHT = 100.0
# bench_all.py's measured siemens-star data (516 patterns of 128^2).
SIEMENS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "tests", "data", "siemens-star-small.npz.bz2",
)

KERNELS = {
    "patch_fwd": "tike_tpu/ops/patch_pallas.py:110",  # also :181
    "patch_adj": "tike_tpu/ops/patch_pallas.py:283",
}
# The KB kernels replace XLA code with no Pallas kernel: the row-structured
# einsum chains laminography runs (also the tap scans gather_kb :214 and
# scatter_kb :244).
USFFT_KERNELS = {
    "usfft_gather_kb": "tike_tpu/ops/usfft.py:330",
    "usfft_scatter_kb": "tike_tpu/ops/usfft.py:364",
}
# The Gaussian model's far-field step replaces XLA code too: the solvers'
# chain from the intensity to the exit-wave update (also rpie.py:113).
FARPLANE_KERNELS = {
    "farplane_gaussian": "tike_tpu/ptycho/solvers/lstsq.py:139",
}
# The Gaussian window (phase 25) runs kernels of its own
# (csrc/usfft_gaussian.cu), counted under names of their own; they replace
# XLA code with no Pallas kernel, tike_tpu's Gaussian tap scans (the original
# tike's usfft.cu gather and scatter; also vector_gather :461 and
# vector_scatter :465). Their first form, the KB kernels on a Gaussian plan,
# is timed beside them in 25a; no path runs it.
GAUSSIAN_KERNELS = {
    "usfft_gather_gaussian": "tike_tpu/ops/usfft.py:401",
    "usfft_scatter_gaussian": "tike_tpu/ops/usfft.py:431",
}
# 25a's upsamples at bench_all.py's 128^3 / 64 angles, eps 1e-3: m = 2 and 4.
GAUSSIAN_UPSAMPLES = (1, 2)
# Phase 26a: laminography's points for a 646^3 volume, 64 angles, tilt
# pi/3, eps 1e-3, upsample 2: a 1292^3 grid, 2,156,689,088 cells, and
# 26,708,224 points (KB m = 2, Gaussian m = 4). At tilt pi/3 no point's base
# cell lies past the 2^31-th (|x0| <= 0.433), so the parity sample adds
# LARGE_HIGH points there to LARGE_SAMPLE of laminography's.
LARGE = dict(n=646, ntheta=64, upsample=2)
LARGE_SAMPLE, LARGE_HIGH, LARGE_REPEATS = 65_536, 8_192, 5
# 26b: phase 25a's points at (eps, upsample) of m = 17, 18 and 22, held to
# the plain versions on WIDE_SAMPLE of them (the plain loop is (2m)^3
# indexed passes); WIDE_REPEATS launches timed.
WIDE_CASES = ((1e-10, 3), (1e-8, 4), (1e-10, 4))
WIDE_SAMPLE, WIDE_REPEATS = 16_384, 5
# 26c: cgrad at 646^3 with both windows, one warm-up outer iteration, then
# LARGE_TIMED; and a slice at m = 18 (upsample 4, eps 1e-8), card against
# CPU, in 25c's runs at upsample 1: a 10^3 volume and 4 angles (a 40^3 grid,
# the least that holds 2m = 36 taps a little more), as the CPU's plain loop
# makes (2m)^3 = 46,656 passes a transform.
LARGE_CG_ITER, LARGE_TIMED = 2, 2
WIDE_SLICE = dict(n=10, ntheta=4, upsample=4, eps=1e-8)
# The Gaussian gather's form above 32 taps (gaussian_gather_wide_kernel), a
# kernel of its own in usfft_gaussian.cu behind the same entry point.
WIDE_GATHER = "usfft_gather_gaussian_wide"
# The feature probes' pl.pallas_call lines.
PROBE_KERNELS = {
    "trivial": "scripts/pallas_probe.py:45",
    "gridded": "scripts/pallas_probe.py:56",
    "prefetch": "scripts/pallas_probe.py:84",
    "static_dma": "scripts/pallas_probe.py:102",
    "dynamic_dma": "scripts/pallas_probe.py:146",
    "element_static": "scripts/pallas_probe.py:161",
    "element_prefetch": "scripts/pallas_probe.py:199",
}
# The Bucket kernels replace XLA code with no Pallas kernel: the scatter-add
# and the gather of tike_tpu's bucket operator.
BUCKET_KERNELS = {
    "bucket_fwd": "tike_tpu/ops/bucket.py:101",
    "bucket_adj": "tike_tpu/ops/bucket.py:126",
}
# The Bucket kernels' first form (csrc/bucket_first_form.cu) is built with
# them and timed beside them in phase 16; no path runs it.
# The Lanczos remap kernels replace XLA code with no Pallas kernel (the
# original tike's interp.cu:218-237): tike_tpu's tap scans.
INTERP_KERNELS = {
    "lanczos_fwd": "tike_tpu/ops/interp.py:36",
    "lanczos_adj": "tike_tpu/ops/interp.py:71",
}
# So are the Lanczos kernels' (csrc/interp_first_form.cu) in phase 19a.
SOURCES = ("patch", "farplane", "usfft", "usfft_gaussian", "probe", "bucket", "bucket_first_form",
           "interp", "interp_first_form")
# The probe kernels redesigned last, timed beside their parent's form.
PARENT_FORM_PROBES = ("gridded", "prefetch")

# Laminography (bench_all.py's lamino_cgrad and lamino_cgls): a 128^3
# volume, 64 angles, tilt pi/3, eps 1e-3, upsample 1, one warm-up outer
# iteration, then 5 timed, cg_iter 4 inner steps each.
LAMINO_CG_ITER, LAMINO_TIMED = 4, 5
# Timed runs of each solver: the first is the counted one, the others show
# the spread of the host's clock.
LAMINO_ROUNDS = 3
# The small laminography slice, card against CPU: n = 16, 8 angles,
# upsample 2, 3 outer iterations; cgrad with one CG step per outer
# iteration, so that no line-search trial is a tie (tests/
# test_torch_lamino_solvers.py), CGLS with 4. The card's kernels sum in
# another order than the plain versions and cuFFT rounds otherwise than
# pocketfft; CGLS carries that forward (relative, costs and volume).
LAMINO_SLICE = dict(n=16, ntheta=8, upsample=2, num_iter=3)
LAMINO_SLICE_CG_ITER = {"cgrad": 1, "cgls": 4}
# 25c's runs, (algorithm, cg_iter, outer iterations), at each upsample. At
# upsample 1 the Gaussian slice's CGLS carries any rounding forward a
# thousandfold past its eighth CG step: the data changed by 1e-7 of itself,
# or another summation order of the interpolation, moves its costs at cg_iter
# 4 after three outer iterations by about 1e-4 (phase_gaussian_slice_orders
# logs both), so a card-against-CPU check there reads rounding, not the
# port. CGLS takes cg_iter 4 for one outer iteration (every CG step's
# kernels) and cg_iter 1 for three (the outer loop, costs falling).
GAUSSIAN_SLICE_RUNS = {
    1: (("cgrad", 1, 3), ("cgls", 4, 1), ("cgls", 1, 3)),
    2: tuple((a, cg, LAMINO_SLICE["num_iter"]) for a, cg in LAMINO_SLICE_CG_ITER.items()),
}
LAMINO_SLICE_TOL = 1e-4
# simulate at full width, card against CPU, relative to the largest value:
# the same taps (make_grids is the same bits on both), other FFT libraries.
LAMINO_SIM_TOL = 1e-5


# Joint ADMM (bench_all.py's admm_joint): an n^3 volume, T angles, a
# P-pixel probe and NPOS positions per angle, 10 keV, 1e-7 cm voxels; one
# warm-up iteration, then ADMM_TIMED iterations, ADMM_ROUNDS times.
ADMM = dict(n=64, P=16, T=8, NPOS=200)
ADMM_SLICE = dict(n=16, P=8, T=3, NPOS=30)
# The KB kernels' case at the points of ADMM's volume fit and re-projection.
ADMM_USFFT_CASE = f"{ADMM['n']}^3 / {ADMM['T']} angles at tilt pi/2, upsample 2 (admm_joint)"
ADMM_ENERGY, ADMM_VOXEL = 10.0, 1e-7
ADMM_TIMED, ADMM_ROUNDS = 3, 3
# The ADMM slice, card against CPU: psi and the costs, which do not pass
# through the volume fit within one iteration, take SLICE_TOL. The fit is
# cgrad at cg_iter 4, whose line search decides some trials on ties that the
# FFT library's last bits break (ROADMAP.md section 3), so the iteration's
# own volumes may part and their gap is printed only; the fit of the same
# phi at cg_iter 1 and its re-projection take LAMINO_SLICE_TOL.
# Host streaming (bench_all.py's stream_1m): 1,000,000 patterns of 64^2, a
# 4096^2 object, rPIE, 100 random batches; its comparison at 100,000
# patterns in 10 batches. Peak device memory must stay under the limit:
# two batches and the model, whatever the number of patterns.
STREAM = dict(n_patterns=1_000_000, det=64, hw=4096, num_batch=100)
STREAM_COMPARE = dict(n_patterns=100_000, det=64, hw=4096, num_batch=10)
STREAM_PEAK_LIMIT = 4e9
# Bucket laminography (phase 16) at bench_all.py's laminography geometry
# (cases_bucket.FULL: 128^3, 64 angles in [0, pi), tilt pi/3) with the
# Bucket solver's default eps 1e-1 (precision 3) and cg_iter 4: one warm-up
# outer iteration, then BUCKET_TIMED timed ones.
BUCKET_TIMED = 5
# Multislice rPIE (phase 18): tests/ptycho/test_multislice_recon.py's
# optics (wavelength, field of view, slice distance), its 2-slice 96^2
# problem card against CPU, then the main path's data and geometry with
# MULTISLICE_SLICES slices at full width.
MULTISLICE_OPTICS = dict(
    probe_wavelength=1.4e-10, probe_FOV_lengths=(1e-6, 1e-6),
    multislice_propagation_distance=2e-8,
)
MULTISLICE_SLICES = 3
# Alignment (phase 19c): ALIGN_IMAGES projections of ALIGN_N^2, shifts of
# up to ALIGN_SHIFT px, a rotation of ALIGN_ANGLE rad and a flow of a few px;
# cross-correlation at upsample ALIGN_UPSAMPLE must find every shift within
# ALIGN_SHIFT_TOL px. The golden dataset (19b) is held at the reference's
# atol (tests/test_parity_golden.py).
ALIGN_IMAGES, ALIGN_N = cases_interp.FULL_IMAGES, cases_interp.FULL_N
ALIGN_SHIFT, ALIGN_ANGLE, ALIGN_UPSAMPLE, ALIGN_SHIFT_TOL = 8.0, 0.05, 10, 0.15
ALIGN_GOLDEN = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "data", "algin_setup.pickle.lzma"
)
ALIGN_GOLDEN_ATOL = 1e-6
# The rest of ptycho (phase 17): multigrid at the main path's configuration,
# MULTIGRID_EPOCHS epochs at each of 3 levels (32^2, 64^2, 128^2 patterns).
MULTIGRID_LEVELS, MULTIGRID_EPOCHS = 3, 2
# The public API by hand (phase 20): the zone plate and optics of the
# original tike's fresnel test (10 keV, 20 nm pixels, 800 um defocus);
# adjust_probe_power on the card against the CPU, relative to the largest
# value; the windows of patch_fwd_padded and of the Fourier patch pair, the
# padded width, and the pair's adjointness gap (float32 values, sums in
# double precision).
API_OPTICS = dict(lambda0=1.24e-9 / 10, dx=20e-9, dis_defocus=800e-6, zone_plate_params="velo")
API_POWER_TOL = 1e-6
API_WINDOWS, API_PADDED = 1000, 256
API_ADJOINT_TOL = 1e-5
# The examples and scripts (phase 24): the kernels each runs at its own
# size, which must read more than 0 after its run (the Lanczos pair runs in
# none: the align example's warp is a shift alone).
_PATCH, _KB = ("patch_fwd", "patch_adj"), ("usfft_gather_kb", "usfft_scatter_kb")
EXAMPLE_KERNELS = {
    "scan": (), "align": (), "lamino": _KB + ("bucket_fwd", "bucket_adj"), "ptycho": _PATCH,
    "admm": _PATCH + _KB, "admm_quality": _PATCH + _KB, "striped_demo": _PATCH,
    "longaxis_demo": _PATCH,
}
# The align example's shift error at upsample 16 (a 1/16 px grid), in px.
EXAMPLE_SHIFT_TOL = 0.1
# admm_quality (tests/test_admm_quality.py): phantom -> (iterations, rho,
# the pinned volume correlation).
QUALITY = {"cube": (24, 2.0, 0.88), "blobs": (12, 0.5, 0.93)}
# The striped demo's size (scripts/striped_demo.py's defaults) and the
# long-axis demo's pattern count, cut from 1,000,000 (phase 15 runs that).
STRIPED_DEMO = dict(H=4096, NPOS=4096)
LONGAXIS_PATTERNS = 100_000


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _installed_version(package: str) -> str:
    try:
        return importlib.metadata.version(package)
    except importlib.metadata.PackageNotFoundError:
        return "not installed"


def phase_environment() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = kernels.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    env = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
        "nvcc": nvcc_version,
        "triton": _installed_version("triton"),
    }
    log(f"[env] python {sys.version.split()[0]} torch {env['torch']} "
        f"cuda {env['cuda']}")
    log(f"[env] device {env['device']} (count {env['count']})")
    log(f"[env] nvidia-smi: {env['nvidia_smi']}")
    log(f"[env] nvcc: {nvcc_version}; triton: {env['triton']}")
    return env


def phase_build():
    """Build every source with one nvcc each, all started together, and
    ``probe.cu`` in its parent's form; returns the latter, loaded."""
    start = time.perf_counter()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe_source = (kernels.CSRC / "probe.cu").read_text()
    parent = kernel_sweep.start_builds(
        "probe",
        {"parent form": kernel_sweep.variant_source(
            probe_source, kernel_sweep.parent_form(probe_source))},
        kernels.BUILD_DIR,
    )
    kernels.build_all(SOURCES)
    libs, failed = kernel_sweep.finish_builds("probe", parent)
    if failed:
        raise RuntimeError(f"nvcc failed on probe.cu in its parent's form:\n{failed}")
    log(f"[build] {len(SOURCES) + 1} sources in {time.perf_counter() - start:.2f} s")
    for name in SOURCES:
        kernels.load(name)
        info = kernels.BUILD_INFO[name]
        log(f"[build] csrc/{name}.cu -> {info['path']} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {line.strip()}")
    return libs["parent form"]


def _ms_per_call(fn, reps: int) -> float:
    """Device ms per call over ``reps`` back-to-back calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms_per_call(fn, reps: int = 20, rounds: int = 3) -> float:
    """Device ms per call of ``fn``, captured ``reps`` times into one CUDA
    graph and replayed ``rounds`` times (median): the kernels' own time,
    without the host's launch overhead between eager calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(_ms_per_call(graph.replay, 1) / reps for _ in range(rounds))


def graph_ms_in_turns(fns: dict) -> dict:
    """Median ms per call of each function of ``fns`` by
    :func:`graph_ms_per_call`, in turns: in their order, in the reverse
    order, in order again."""
    times = {name: [] for name in fns}
    order = list(fns)
    for turn in (order, order[::-1], order):
        for name in turn:
            times[name].append(graph_ms_per_call(fns[name]))
    return {name: statistics.median(t) for name, t in times.items()}


def median_ms_in_turns(fns: dict, reps: int = 20, rounds: int = 3) -> dict:
    """Median ms per call of each function of ``fns``, timed in turns: in
    their order, then in the reverse order, ``rounds`` times (plain,
    library, kernel, kernel, library, plain)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            times[name].append(_ms_per_call(fns[name], reps))
    return {name: statistics.median(t) for name, t in times.items()}


def compact_batch_positions(device):
    """1,000 positions as one compact batch of the main path holds them: of
    10,000 drawn as ``make_inputs`` draws them, the 1,000 nearest the scan's
    centre (a disc of a tenth of its area), in ascending index. Their windows
    pile up about ten deep, where uniform ones are seven deep, and touch only
    the disc and a window's width around it."""
    scan, _, _ = make_inputs(N_PATTERNS)
    dist = np.linalg.norm(scan - np.mean(scan, axis=0), axis=1)
    nearest = np.sort(np.argsort(dist)[:BATCH])
    return torch.tensor(scan[nearest], device=device)


def _library_calls(image, patches, positions):
    """One PyTorch call for each kernel that computes the same function on
    these inputs (``grid_sample`` and its input gradient, on a planar copy
    of the image made here), and the calls' outputs checked against the
    kernels' to ``cases.LIBRARY_TOL``: the calls and their errors."""
    planar, grid = cases.grid_sample_inputs(image, positions, PROBE)
    grad = torch.view_as_real(patches).permute(3, 0, 1, 2).reshape(
        1, 2, BATCH * PROBE, PROBE
    ).contiguous()
    calls = {
        "patch_fwd": lambda: torch.nn.functional.grid_sample(
            planar, grid, mode="bilinear", padding_mode="zeros", align_corners=True
        ),
        "patch_adj": lambda: torch.ops.aten.grid_sampler_2d_backward(
            grad, planar, grid, 0, 0, True, [True, False]
        )[0],
    }
    errs = {
        "patch_fwd": cases.check_library(
            "patch_fwd",
            cases.planar_to_complex(calls["patch_fwd"](), (BATCH, PROBE, PROBE)),
            patch.patch_fwd_cuda(image, positions, PROBE),
        ),
        "patch_adj": cases.check_library(
            "patch_adj",
            cases.planar_to_complex(calls["patch_adj"](), (HW, HW)),
            patch.patch_adj_cuda(patches, positions, (HW, HW)),
        ),
    }
    return calls, errs


LIBRARY = {
    "patch_fwd": "torch.nn.functional.grid_sample (bilinear, zeros, align_corners)",
    "patch_adj": "torch.ops.aten.grid_sampler_2d_backward (input gradient)",
}


def phase_kernel_parity(device, card: str) -> dict:
    image, positions, patches = cases.main_path_patch_inputs(device)
    # complex64 on the main path; float32 is the kernels' other
    # instantiation (the gather psi preconditioner spreads |probe|^2).
    errs = cases.check_patch_kernels(image, positions, patches, PROBE, "complex64")
    real = cases.check_patch_kernels(
        image.real.contiguous(), positions, torch.square(torch.abs(patches)),
        PROBE, "float32",
    )
    for name in errs:
        errs[name] = max(errs[name], real[name])
    log(f"[parity] {BATCH}x{PROBE}^2 at {HW}^2, complex64 and float32: "
        f"patch_fwd max|err| {errs['patch_fwd']:.3e} (tol {cases.FWD_TOL:g}), "
        f"patch_adj {errs['patch_adj']:.3e} (tol {cases.ADJ_TOL:g} x max|value|); "
        "two launches of each bitwise equal")
    compact = compact_batch_positions(device)
    errs_compact = cases.check_patch_kernels(image, compact, patches, PROBE, "compact batch")
    log(f"[parity] one compact batch: patch_fwd max|err| "
        f"{errs_compact['patch_fwd']:.3e}, patch_adj {errs_compact['patch_adj']:.3e}; "
        "two launches of each bitwise equal")
    for name in cases.EDGE_CASES:
        edge = cases.check_patch_kernels(*cases.edge_case(name, device), name)
        log(f"[parity] edge case {name}: patch_fwd max|err| "
            f"{edge['patch_fwd']:.3e}, patch_adj {edge['patch_adj']:.3e}; "
            "two launches of each bitwise equal")

    # Each kernel, its plain version and its library call on the uniform
    # positions; then the kernel and the library call on one compact
    # batch's, as the main path's epochs give them. Each bound counts what
    # those positions need (cases.roofline).
    library, lib_err = _library_calls(image, patches, positions)
    library_compact, _ = _library_calls(image, patches, compact)
    calls = {
        "patch_fwd": dict(
            plain=lambda: patch.patch_fwd_plain(image, positions, PROBE),
            library=library["patch_fwd"],
            kernel=lambda: patch.patch_fwd_cuda(image, positions, PROBE),
        ),
        "patch_adj": dict(
            plain=lambda: patch.patch_adj_plain(patches, positions, (HW, HW)),
            library=library["patch_adj"],
            kernel=lambda: patch.patch_adj_cuda(patches, positions, (HW, HW)),
        ),
    }
    compact_calls = {
        "patch_fwd": dict(
            library=library_compact["patch_fwd"],
            kernel=lambda: patch.patch_fwd_cuda(image, compact, PROBE),
        ),
        "patch_adj": dict(
            library=library_compact["patch_adj"],
            kernel=lambda: patch.patch_adj_cuda(patches, compact, (HW, HW)),
        ),
    }
    out = {}
    for name, fns in calls.items():
        ms = median_ms_in_turns(fns)
        ms_compact = median_ms_in_turns(compact_calls[name])
        bound = cases.roofline(name, positions, PROBE, (HW, HW), torch.complex64)
        bound_compact = cases.roofline(name, compact, PROBE, (HW, HW), torch.complex64)
        out[name] = dict(
            max_abs_err=errs[name],
            ms=ms["kernel"],
            plain_ms=ms["plain"],
            library_ms=ms["library"],
            library=LIBRARY[name],
            library_max_abs_err=lib_err[name],
            **bound,
            roofline_share=bound["bound_ms"] / ms["kernel"],
            ms_compact_batch=ms_compact["kernel"],
            bound_bytes_compact_batch=bound_compact["bound_bytes"],
            bound_ms_compact_batch=bound_compact["bound_ms"],
            roofline_share_compact_batch=bound_compact["bound_ms"] / ms_compact["kernel"],
            library_ms_compact_batch=ms_compact["library"],
            deterministic=True,
            card=card,
        )
        log(f"[parity] {name} {BATCH}x{PROBE}^2 / {HW}^2: kernel {ms['kernel']:.4f} "
            f"ms, plain {ms['plain']:.4f} ms, library {ms['library']:.4f} ms "
            f"({LIBRARY[name]}; max|err| vs kernel {lib_err[name]:.3e}); bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_bytes']} bytes at "
            f"{cases.HBM_BYTES_PER_S:g} B/s), {100 * out[name]['roofline_share']:.1f}% "
            f"of it ({card})")
        log(f"[parity] {name} on one compact batch: kernel "
            f"{ms_compact['kernel']:.4f} ms, bound {bound_compact['bound_ms']:.4f} ms "
            f"({bound_compact['bound_bytes']} bytes), "
            f"{100 * out[name]['roofline_share_compact_batch']:.1f}% of it; "
            f"library {ms_compact['library']:.4f} ms ({card})")
    return out


def make_inputs(n_patterns, probe_shape=PROBE, hw=HW):
    """bench.py's _make_inputs recipe (seed 0): scan, object, probe."""
    rng = np.random.default_rng(0)
    scan = np.stack(
        [
            rng.uniform(2, hw - probe_shape - 3, n_patterns),
            rng.uniform(2, hw - probe_shape - 3, n_patterns),
        ],
        -1,
    ).astype(np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    psi = (
        np.exp(1j * 0.5 * np.sin(17 * yy) * np.cos(13 * xx))
        * (0.9 + 0.1 * np.cos(23 * xx * yy))
    ).astype(np.complex64)[None]
    win = tp.gaussian(probe_shape)
    probe = (win * np.exp(1j * 0.2 * win))[None, None, None].astype(np.complex64)
    return scan, psi, probe


def simulate_numpy(det, probe, scan, psi, eigen_probe=None, eigen_weights=None):
    """Numpy forward model: bilinear patch, probe product, zero-pad, ortho
    FFT, intensity summed over probe modes (bench.py's _simulate_numpy).

    With eigen weights, the probe at position k is ``w[k, 0] * probe +
    sum_e w[k, 1 + e] * eigen_probe[e]``, mode by mode."""
    p = probe.shape[-1]
    probe2d = probe[0, 0][None]  # (1, M, P, P)
    if eigen_weights is not None:
        w = eigen_weights[:, :, :, None, None]
        probe2d = w[:, 0] * probe[0, 0]
        if eigen_probe is not None:
            m = eigen_probe.shape[-3]
            probe2d[:, :m] += np.sum(w[:, 1:, :m] * eigen_probe[0][None, :, :m], axis=1)
    corner = np.floor(scan).astype(np.int64)
    frac = scan - corner
    pats = np.empty((len(scan), p, p), np.complex64)
    for k, (c, f) in enumerate(zip(corner, frac)):
        win = psi[0, c[0] : c[0] + p + 1, c[1] : c[1] + p + 1]
        fy, fx = f
        pats[k] = (
            (1 - fy) * (1 - fx) * win[:-1, :-1]
            + (1 - fy) * fx * win[:-1, 1:]
            + fy * (1 - fx) * win[1:, :-1]
            + fy * fx * win[1:, 1:]
        )
    near = pats[:, None] * probe2d
    pad = (det - p) // 2
    if pad or det != p:
        near = np.pad(near, ((0, 0), (0, 0), (pad, det - p - pad), (pad, det - p - pad)))
    far = np.fft.fft2(near, norm="ortho")
    return np.sum(np.abs(far) ** 2, axis=1).astype(np.float32)


def phase_forward_model(device, scan, psi, probe, n=256) -> None:
    probe3 = tp.add_modes_cartesian_hermite(probe, MODES)
    eigen_probe, weights = config2_eigen(probe3, n)
    # Weights that differ per position, so the blend is exercised.
    weights[:, 1] = np.linspace(-50, 50, n, dtype=np.float32)[:, None]
    for name, probe_k, eig, w in (
        ("1 mode", probe, None, None),
        (f"{MODES} modes", probe3, None, None),
        (f"{MODES} modes + eigen probe", probe3, eigen_probe, weights),
    ):
        got = tp.simulate(
            DET, probe_k, scan[:n], psi, eigen_probe=eig, eigen_weights=w,
            device=device,
        )
        if not (isinstance(got, np.ndarray) and got.dtype == np.float32):
            raise AssertionError(f"simulate returned {type(got)}, not a float32 numpy array")
        want = simulate_numpy(DET, probe_k, scan[:n], psi, eig, w)
        atol = SIM_ATOL * float(np.max(want))
        np.testing.assert_allclose(got, want, rtol=SIM_RTOL, atol=atol)
        err = float(np.max(np.abs(got - want)))
        log(f"[forward] simulate {name}, {n}x{DET}^2 on {device} vs numpy: "
            f"max|err| {err:.3e} (rtol {SIM_RTOL:g}, atol {atol:.3e})")


def _small_slice_parameters(scan, probe, psi0, det, config2=False):
    extra = {}
    if config2:
        probe = tp.add_modes_cartesian_hermite(probe, MODES)
        extra = config2_extra(scan, probe)
    return tp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=tp.LstsqOptions(
            num_batch=3, batch_method="compact", rescale_period=2
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        exitwave_options=tp.ExitWaveOptions(
            measured_pixels=np.ones((det, det), bool)
        ),
        **extra,
    )


def _slice_inputs(gen, probe_fn, h=160, p=16, n=120):
    """The small slices' scan, true object, starting probe (``probe_fn(gen,
    p)``) and perturbed starting object, drawn from ``gen`` in that
    order."""
    scan = gen.uniform(2, h - p - 3, (n, 2)).astype(np.float32)
    _, psi, _ = make_inputs(1, probe_shape=p, hw=h)
    probe = probe_fn(gen, p)
    psi0 = (
        0.5
        + 0.05 * (gen.standard_normal(psi.shape) + 1j * gen.standard_normal(psi.shape))
    ).astype(np.complex64)
    return scan, psi, probe, psi0


def _random_phase_probe(gen, p):
    """The soft-edged aperture with a random phase, one mode."""
    return (tp.gaussian(p) * np.exp(1j * gen.uniform(-np.pi, np.pi, (p, p))))[
        None, None, None
    ].astype(np.complex64)


def _card_vs_cpu(name, device, data, make_params, keys=("psi", "probe"), phase=False):
    """3 epochs of ``make_params()`` on the card and on the CPU from the
    same data and seed; costs and ``keys`` must agree to SLICE_TOL (probes
    up to one phase per mode with ``phase``). Returns both results."""
    results = {}
    for dev in ("cpu", device):
        with tp.Reconstruction(data, make_params(), device=dev, random_seed=0) as context:
            context.iterate(3)
            results[str(dev)] = context.get_result()
    ref, got = results["cpu"], results[str(device)]
    c_ref = np.asarray(ref.algorithm_options.costs)
    c_got = np.asarray(got.algorithm_options.costs)
    if not (np.all(np.isfinite(c_got)) and c_got[-1, 0] < c_got[0, 0]):
        raise AssertionError(f"{name}: costs not finite and decreasing: {c_got.ravel()}")
    np.testing.assert_allclose(c_got, c_ref, rtol=SLICE_TOL)
    errs = {}
    for key in keys:
        a, b = getattr(got, key), getattr(ref, key)
        if phase and key == "probe":
            inner = np.sum(np.conj(a) * b, axis=(-2, -1), keepdims=True)
            a = a * np.exp(1j * np.angle(inner))
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
        errs[key] = float(np.max(np.abs(a - b)) / np.abs(b).max())
    log(f"[slice] {name}: 3 epochs on {device} vs cpu: costs {c_got.ravel().tolist()} "
        f"vs {c_ref.ravel().tolist()} (rtol {SLICE_TOL:g}); max|err| / max|value| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol {SLICE_TOL:g})")
    return got, ref


def phase_small_slice(device, config2=False) -> None:
    """3 LSQML epochs at 160^2 / P=16 / 24^2 detector, card vs CPU; with
    ``config2`` the probe has 3 modes, an eigen probe and weights, and the
    positions are corrected."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(1), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu")
    name = "config-2 slice (3 modes, eigen probe, positions)" if config2 else "slice"
    keys = ("psi", "probe") + (("eigen_probe", "eigen_weights") if config2 else ())
    got, ref = _card_vs_cpu(
        name, device, data,
        lambda: _small_slice_parameters(scan, probe, psi0, det, config2), keys,
    )
    scan_err = float(np.max(np.abs(got.scan - ref.scan)))
    np.testing.assert_allclose(got.scan, ref.scan, rtol=0, atol=SLICE_SCAN_TOL)
    if config2 and not np.max(np.abs(got.scan - scan)) > 0.1:
        raise AssertionError("config-2 slice: the positions did not move")
    log(f"[slice] {name}: scan max|err| {scan_err:.3e} px (tol {SLICE_SCAN_TOL:g})")


def _distinct_modes_probe(gen, p):
    """3 Hermite modes of a random-phase blob, at distinct powers, centered
    off the half-integers: equal powers make the orthogonalization's
    eigenvectors ill-conditioned, and a half-integer center is a rounding
    tie for the centering constraint."""
    r, c = np.mgrid[:p, :p] + 0.5
    amp = np.exp(-((r - 0.52 * p) ** 2 + (c - 0.46 * p) ** 2) / (0.3 * p) ** 2)
    base = (amp * np.exp(1j * gen.uniform(-np.pi, np.pi, (p, p))))[None, None, None]
    modes = tp.add_modes_cartesian_hermite(base.astype(np.complex64), MODES)
    return (modes * np.linspace(1.0, 0.4, MODES)[:, None, None]).astype(np.complex64)


def phase_rpie_slices(device) -> None:
    """5c: the rPIE slice with every constraint and moment of this path,
    then one-mode LSQML with Poisson noise, card vs CPU."""
    gen = np.random.default_rng(2)
    scan, psi, probe, psi0 = _slice_inputs(gen, _distinct_modes_probe)
    det = 24
    ones = np.ones((det, det), bool)
    probe = (BRIGHT * probe).astype(np.complex64)
    data = tp.simulate(det, probe, scan, psi, device="cpu")
    eigen_probe, weights = config2_eigen(probe, len(scan))

    def rpie_params():
        return tp.PtychoParameters(
            probe=probe,
            psi=psi0,
            scan=scan,
            eigen_probe=eigen_probe,
            eigen_weights=weights,
            algorithm_options=tp.RpieOptions(
                num_batch=3, rescale_method="constant_probe_photons", rescale_period=2
            ),
            object_options=tp.ObjectOptions(
                smoothness_constraint=0.01,
                positivity_constraint=0.05,
                use_adaptive_moment=True,
            ),
            probe_options=tp.ProbeOptions(
                force_orthogonality=True,
                force_centered_intensity=True,
                probe_support=0.05,
                median_filter_abs_probe=True,
                median_filter_abs_probe_px=(3.0, 3.0),
                force_sparsity=0.05,
                use_adaptive_moment=True,
            ),
            exitwave_options=tp.ExitWaveOptions(measured_pixels=ones),
        )

    _card_vs_cpu(
        "rPIE slice (wobbly center, 3 modes, eigen probe, every probe "
        "constraint, object constraints, AdaM, constant_probe_photons)",
        device, data, rpie_params,
        ("psi", "probe", "eigen_probe", "eigen_weights"), phase=True,
    )
    probe1 = _random_phase_probe(gen, 16)
    data1 = tp.simulate(det, probe1, scan, psi, device="cpu")
    _card_vs_cpu(
        "LSQML slice (1 mode, Poisson, wobbly center)",
        device, data1,
        lambda: tp.PtychoParameters(
            probe=probe1,
            psi=psi0,
            scan=scan,
            algorithm_options=tp.LstsqOptions(num_batch=3, rescale_period=2),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(measured_pixels=ones, noise_model="poisson"),
        ),
    )


def config2_eigen(probe, n_positions):
    """bench_all.py's config-2 eigen state: one eigen probe, 0.01 of the
    shared modes, and weights of 1 on the shared component and 0 on it."""
    eigen_probe = (0.01 * probe[:, :1]).astype(np.complex64)
    weights = np.zeros((n_positions, 2, probe.shape[-3]), np.float32)
    weights[:, 0, :] = 1.0
    return eigen_probe, weights


def config2_extra(scan, probe) -> dict:
    """The PtychoParameters fields config 2 adds to the main path."""
    eigen_probe, weights = config2_eigen(probe, len(scan))
    return dict(
        eigen_probe=eigen_probe,
        eigen_weights=weights,
        position_options=tp.PositionOptions(
            initial_scan=scan, update_magnitude_limit=POS_LIMIT
        ),
    )


def path_parameters(scan, psi, probe, config2=False):
    """The main path's parameters (bench.py), or config 2's
    (bench_all.py:134-176) for a probe that already has its 3 modes."""
    return tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi, 0.5),
        scan=scan,
        algorithm_options=tp.LstsqOptions(
            num_batch=NUM_BATCH, num_iter=1, batch_method="compact"
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        **(config2_extra(scan, probe) if config2 else {}),
    )


def _drive(tag, device, probe, scan, psi, card, params, *, data=None, trace=False, mesh=None,
           **optics) -> dict:
    """Simulate the data on the card from ``psi`` (``optics`` go to
    ``simulate_device``), unless ``data`` is given, then enter a
    Reconstruction of ``params`` and run ``iterate(1)`` and a timed
    ``iterate(3)``, with every kernel count set to 0 just before the timed
    run and read just after, and, with ``trace``, one more epoch traced
    (``_traced_epoch``). Checks what every path shares: 4 finite,
    decreasing costs, both patch kernels launched, the far-field kernel
    launched once a batch and shard (every path here runs the Gaussian
    model), a finite result of the start's shapes. ``mesh`` runs the
    Reconstruction data-parallel on it."""
    if data is None:
        start = time.perf_counter()
        data = tp.simulate_device(DET, probe, scan, psi, device=device, **optics)
        torch.cuda.synchronize()
        log(f"[{tag}] simulated {tuple(data.shape)} {data.dtype} on {device} with "
            f"{probe.shape[-3]} probe mode(s) and {psi.shape[0]} slice(s) in "
            f"{time.perf_counter() - start:.2f} s")
        if not bool(torch.isfinite(data).all()):
            raise AssertionError(f"{tag}: simulated data is not finite")

    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    context = tp.Reconstruction(data, params, device=device, random_seed=0, mesh=mesh)
    context.__enter__()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    plan = context._make_plan()
    fused = context._fused_eligible()
    log(f"[{tag}] Reconstruction entered in {setup_s:.2f} s "
        f"({params.algorithm_options.batch_method} batches "
        f"{context.batches[0].shape}, fft_precond {bool(plan.fft_precond)}, "
        f"{'all epochs enqueued' if fused else 'per-epoch loop'}) ({card})")
    start = time.perf_counter()
    context.iterate(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    scan1 = context.get_scan()
    _reset_launches()
    start = time.perf_counter()
    context.iterate(3)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - start
    launches = _read_launches(tag)
    peak = torch.cuda.max_memory_allocated()

    costs = [c[0] for c in context.get_convergence()[0]]
    result = context.get_result()
    breakdown = _traced_epoch(context, tag) if trace else None
    context.__exit__(None, None, None)
    log(f"[{tag}] per-epoch costs {costs}")
    if len(costs) != 4 or not np.all(np.isfinite(costs)):
        raise AssertionError(f"{tag}: costs are not 4 finite values: {costs}")
    if not costs[-1] < costs[0]:
        raise AssertionError(f"{tag}: cost did not decrease: {costs}")
    for name in patch.LAUNCHES:
        if not launches[name] > 0:
            raise AssertionError(f"{tag}: iterate(3) launched no {name} kernel: {launches}")
    shards = 1 if mesh is None else mesh.size
    far = 3 * context.batches[0].shape[0] * shards
    if launches["farplane_gaussian"] != far:
        raise AssertionError(f"{tag}: iterate(3) launched the far-field kernel "
                             f"{launches['farplane_gaussian']} times, not {far}: {launches}")
    if result.psi.shape != params.psi.shape or not np.all(np.isfinite(result.psi)):
        raise AssertionError(f"{tag}: reconstructed psi is not finite or has the wrong shape")
    if result.probe.shape != probe.shape or not np.all(np.isfinite(result.probe)):
        raise AssertionError(f"{tag}: reconstructed probe is not finite or has the wrong shape")
    epoch_s = timed_s / 3
    log(f"[{tag}] iterate(1) {first_s:.3f} s; iterate(3) {timed_s:.3f} s = "
        f"{epoch_s:.4f} s/epoch, {len(scan) / epoch_s:.1f} patterns/s "
        f"({card})")
    log(f"[{tag}] set-up {setup_s:.2f} s; peak device memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB) ({card})")
    log(f"[{tag}] kernel launches in iterate(3) "
        f"{ {k: launches[k] for k in (*patch.LAUNCHES, *objective.LAUNCHES)} }")
    # Each kernel's bound per launch on this path: the mean, over the
    # batches at their starting positions (each shard's slots of them on a
    # mesh), of what a launch's positions need (cases.roofline).
    batch_scan = torch.as_tensor(scan[context.order[context.batches[0]]], device=device)
    bounds = {
        name: statistics.mean(
            cases.roofline(name, b, probe.shape[-1], params.psi.shape[-2:], torch.complex64)[
                "bound_ms"
            ]
            for batch in batch_scan
            for b in torch.chunk(batch, shards)
        )
        for name in patch.LAUNCHES
    }
    log(f"[{tag}] bound per launch, mean over the {len(batch_scan)} batches of "
        f"{batch_scan.shape[1]} in {shards} shard(s): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in bounds.items()) + f" ({card})")
    return dict(launches=launches, result=result, scan1=scan1, data=data, setup_s=setup_s,
                epoch_s=epoch_s, costs=costs, breakdown=breakdown, plan=plan, fused=fused)


def phase_main_path(device, scan, psi, probe, card: str) -> dict:
    """The main path, and one more epoch traced after the timed ones;
    returns :func:`_drive`'s record of it (its kernel counts, s/epoch,
    costs, result and the traced epoch's breakdown), less the data."""
    params = path_parameters(scan, psi, probe)
    out = _drive("main", device, probe, scan, psi, card, params, trace=True)
    log_breakdown("main", out["breakdown"], card)
    del out["data"]
    return out


def log_breakdown(tag: str, b: dict, card: str) -> None:
    """A traced epoch's wall and busy time, idle share and kernel classes."""
    classes = sorted(b["classes"].items(), key=lambda kv: -kv[1][0])
    log(f"[{tag}] traced epoch: wall {b['wall_us'] / 1e3:.2f} ms, device busy "
        f"{b['busy_us'] / 1e3:.2f} ms, idle {100 * (1 - b['busy_us'] / b['wall_us']):.1f}%, "
        f"{b['activities']} device activities; by class: "
        + "; ".join(f"{k} {v[0] / 1e3:.3f} ms / {v[1]}" for k, v in classes) + f" ({card})")


def phase_config2(device, scan, psi, probe, card: str) -> dict:
    """Config 2 at full width: 3 modes, one eigen probe, positions."""
    probe3 = tp.add_modes_cartesian_hermite(probe, MODES)
    params = path_parameters(scan, psi, probe3, config2=True)
    out = _drive("config2", device, probe3, scan, psi, card, params)
    result = out["result"]
    eigen_probe, weights = config2_eigen(probe3, len(scan))
    for key, start in (("eigen_probe", eigen_probe), ("eigen_weights", weights)):
        value = getattr(result, key)
        if value.shape != start.shape or not np.all(np.isfinite(value)):
            raise AssertionError(f"{key} is not finite or has the wrong shape")
        moved = float(np.max(np.abs(value - start)))
        if not moved > 0:
            raise AssertionError(f"{key} did not move from its start")
        log(f"[config2] {key} {value.shape}: finite, max|change| {moved:.3e}")
    # The host-side affine fit that ends every iterate call with position
    # correction, timed alone: it is inside each iterate's wall time.
    start = time.perf_counter()
    tp.affine_position_regularization(
        result.scan, result.position_options, rng=np.random.default_rng(0)
    )
    log(f"[config2] host affine position fit at {len(scan)} positions: "
        f"{time.perf_counter() - start:.4f} s")
    tp.check_allowed_positions(result.scan, psi, probe3.shape)
    # Each epoch's step is clipped to the limit, then the trimmed mean
    # (itself within the limit) is subtracted.
    for before, after, epochs in ((scan, out["scan1"], 1), (out["scan1"], result.scan, 3)):
        step = float(np.max(np.abs(after - before)))
        if not 0 < step <= 2 * POS_LIMIT * epochs:
            raise AssertionError(
                f"positions moved by {step} px in {epochs} epoch(s); expected "
                f"(0, {2 * POS_LIMIT * epochs}]"
            )
        log(f"[config2] positions moved up to {step:.4f} px in {epochs} epoch(s) "
            f"(bound {2 * POS_LIMIT * epochs:g}); all inside the allowed window")
    return out["launches"]


def rpie_probe(probe):
    """Phase 8's probe: 3 Hermite modes of ``probe`` holding RPIE_PHOTONS
    photons together."""
    probe3 = tp.add_modes_cartesian_hermite(probe, MODES)
    return (probe3 * np.sqrt(RPIE_PHOTONS / np.sum(np.abs(probe3) ** 2))).astype(
        np.complex64
    )


def rpie_parameters(scan, psi, probe):
    """Phase 8's parameters: rPIE with its defaults (wobbly-center batches,
    alpha 0.05) and the constraints and moments users add to it."""
    return tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi, 0.5),
        scan=scan,
        algorithm_options=tp.RpieOptions(num_batch=RPIE_NUM_BATCH),
        object_options=tp.ObjectOptions(use_adaptive_moment=True, clip_magnitude=True),
        probe_options=tp.ProbeOptions(
            force_orthogonality=True,
            force_centered_intensity=True,
            use_adaptive_moment=True,
        ),
    )


def phase_rpie(device, scan, psi, probe, card: str) -> dict:
    """rPIE at full width: 3 modes holding RPIE_PHOTONS photons,
    wobbly-center batches, orthogonal and centered probe modes, AdaM,
    magnitude clipping."""
    probe3 = rpie_probe(probe)
    out = _drive("rpie", device, probe3, scan, psi, card, rpie_parameters(scan, psi, probe3))
    result = out["result"]
    powers = np.asarray(result.probe_options.power)
    log(f"[rpie] probe mode powers after each epoch's orthogonalization "
        f"{powers.tolist()}")
    if not np.all(np.diff(powers, axis=-1) <= 0):
        raise AssertionError(f"mode powers not in descending order: {powers}")
    final = np.sum(np.abs(result.probe) ** 2, axis=(-2, -1)).ravel()
    log(f"[rpie] final probe mode powers {final.tolist()}")
    top = float(np.max(np.abs(result.psi)))
    if not top <= 1.0 + 1e-6:
        raise AssertionError(f"max |psi| {top} > 1 with clip_magnitude")
    log(f"[rpie] max |psi| {top:.7f} <= 1 (clip_magnitude)")
    return out["launches"]


def siemens():
    """bench_all.py's _siemens(): the measured data, scan and probe, and a
    constant object covering the scan with a 20-pixel margin."""
    with bz2.open(SIEMENS, "rb") as f:
        a = np.load(f)
        scan = a["scan"][0].astype(np.float32)
        data = a["data"][0].astype(np.float32)
        probe = a["probe"][0].astype(np.complex64)
    scan = scan - np.amin(scan, axis=-2) + 20
    w = probe.shape[-1]
    h = int(np.ceil(scan[:, 0].max())) + w + 21
    ww = int(np.ceil(scan[:, 1].max())) + w + 21
    return data, scan, probe, np.full((1, h, ww), 0.5 + 0j, dtype=np.complex64)


def phase_siemens(device, card: str) -> None:
    """bench_all.py's rpie_siemens on the card against the CPU path."""
    data, scan, probe, psi = siemens()

    def params():
        return tp.PtychoParameters(
            probe=probe,
            psi=psi,
            scan=scan,
            algorithm_options=tp.RpieOptions(num_batch=5, batch_method="compact"),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
        )

    got, _ = _card_vs_cpu(
        f"rpie_siemens ({data.shape[0]} measured {data.shape[-1]}^2 patterns)",
        device, data, params,
    )
    epoch_s = float(np.mean(got.algorithm_options.times))
    log(f"[siemens] {epoch_s:.4f} s/epoch on the card (mean of 3, first epoch "
        f"included), {data.shape[0] / epoch_s:.1f} patterns/s ({card})")


def _usfft_cases(device):
    """The KB kernels' parity cases: name -> (grid size, m, beta, points):
    laminography's rows at bench_all.py's 128^3 / 64 angles (upsample 1 and
    2), flat random points of which about a third wrap, at m = 1, 2, 4 and
    7 (the generic path; upsample 2 at eps 1e-12), the rows of a 256^3
    / 128-angle transform, and the points of the joint-ADMM path (ADMM's
    volume and angles at tilt pi/2, upsample 2: every detector row in one
    plane of the grid)."""
    gen = np.random.default_rng(0)
    rows = cases_usfft.lamino_rows(128, 64, device).reshape(-1, 3)
    flat = cases_usfft.flat_points(gen, 200_000, device)
    eps = cases_usfft.LAMINO_EPS
    return {
        "128^3 / 64 angles, upsample 1": (*cases_usfft.window_for(128, eps, 1), rows),
        "128^3 / 64 angles, upsample 2": (*cases_usfft.window_for(128, eps, 2), rows),
        "flat wrapped points, m = 1": (*cases_usfft.window_for(64, eps, 1), flat),
        "flat wrapped points, m = 2": (*cases_usfft.window_for(32, eps, 2), flat),
        "flat wrapped points, m = 4": (*cases_usfft.window_for(32, 1e-6, 2), flat),
        "flat wrapped points, m = 7": (*cases_usfft.window_for(32, 1e-12, 2), flat),
        "256^3 / 128 angles, upsample 1": (
            *cases_usfft.window_for(256, eps, 1),
            cases_usfft.lamino_rows(256, 128, device).reshape(-1, 3),
        ),
        ADMM_USFFT_CASE: (
            *cases_usfft.window_for(ADMM["n"], eps, 2),
            cases_usfft.lamino_rows(ADMM["n"], ADMM["T"], device, np.pi / 2).reshape(-1, 3),
        ),
    }


def _timed_plan(x, n, m, param, tile=None, rounds=3, window="kb"):
    """``window``'s plan of these points and the median host ms of building
    it (synchronised before and after)."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = time.perf_counter()
        plan = usfft.geometry_plan(x, n, m, param, tile, window)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))
    return plan, statistics.median(times)


def phase_usfft_parity(device, card: str) -> dict:
    """The KB kernels against their plain versions and adjointness on every
    case of ``_usfft_cases``, every repeated launch bitwise equal; times
    beside the bounds, with the einsum formulation of tike_tpu (cuBLAS,
    TF32 off) as the yardstick at 128^3 / 64 angles."""
    gen = torch.Generator(device=device).manual_seed(0)
    inputs, errs = {}, {}
    for name, (n, m, beta, x) in _usfft_cases(device).items():
        grid = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=gen)
        f = torch.randn(x.shape[0], dtype=torch.complex64, device=device, generator=gen)
        e = cases_usfft.check_kernels(grid, x, f, n, m, beta, name)
        inputs[name], errs[name] = (grid, x, f, n, m, beta), e
        log(f"[usfft] {name}: grid {n}^3, m = {m}, {x.shape[0]} points: gather "
            f"max|err| {e['usfft_gather_kb_abs']:.3e} ({e['usfft_gather_kb']:.2e} of "
            f"max|value|), scatter {e['usfft_scatter_kb_abs']:.3e} "
            f"({e['usfft_scatter_kb']:.2e}; tol {cases_usfft.KB_TOL:g}); adjointness "
            f"{e['adjoint']:.2e} (tol {cases_usfft.ADJOINT_TOL:g}); three gathers and "
            "three scatters (two on one plan, one building its own) bitwise equal")

    main = "128^3 / 64 angles, upsample 1"
    timed = (
        main, "128^3 / 64 angles, upsample 2", "256^3 / 128 angles, upsample 1", ADMM_USFFT_CASE,
    )
    # Each kernel's plan as laminography builds it (the gather's own order
    # at m = 1), with the time of building it.
    plans = {}
    for case in timed:
        _, x, _, n, m, beta = inputs[case]
        plans[case] = {
            "usfft_gather_kb": _timed_plan(x, n, m, beta, usfft.gather_tile(m)),
            "usfft_scatter_kb": _timed_plan(x, n, m, beta),
        }

    grid, x, f, n, m, beta = inputs[main]
    rows = x.reshape(64 * 128, 128, 3)
    f_rows = f.reshape(64 * 128, 128)
    einsum = {
        "usfft_gather_kb": lambda: cases_usfft.gather_rows_einsum(grid, rows, n, m, beta),
        "usfft_scatter_kb": lambda: cases_usfft.scatter_rows_einsum(f_rows, rows, n, m, beta),
    }
    einsum_err = {
        "usfft_gather_kb": cases_usfft.max_rel(
            einsum["usfft_gather_kb"]().reshape(-1), usfft.gather_kb_cuda(grid, x, n, m, beta)
        ),
        "usfft_scatter_kb": cases_usfft.max_rel(
            einsum["usfft_scatter_kb"](), usfft.scatter_kb_cuda(f, x, n, m, beta)
        ),
    }
    for name, err in einsum_err.items():
        if not err <= cases_usfft.EINSUM_TOL:
            raise AssertionError(f"{name}: the einsum yardstick differs by {err:.3e}")

    def calls(case, name):
        grid, x, f, n, m, beta = inputs[case]
        plan = plans[case][name][0]
        if name == "usfft_gather_kb":
            return dict(
                plain=lambda: usfft.gather_kb_plain(grid, x, n, m, beta),
                kernel=lambda: usfft.gather_kb_cuda(grid, x, n, m, beta, plan),
                own_plan=lambda: usfft.gather_kb_cuda(grid, x, n, m, beta),
            )
        return dict(
            plain=lambda: usfft.scatter_kb_plain(f, x, n, m, beta),
            kernel=lambda: usfft.scatter_kb_cuda(f, x, n, m, beta, plan),
            own_plan=lambda: usfft.scatter_kb_cuda(f, x, n, m, beta),
        )

    out = {}
    for name in USFFT_KERNELS:
        plan, plan_ms = plans[main][name]
        ms = median_ms_in_turns({**calls(main, name), "library": einsum[name]})
        graph_ms = graph_ms_per_call(calls(main, name)["kernel"])
        bound = cases_usfft.roofline(name, x, n, m)
        flops = cases_usfft.einsum_flops(64 * 128, 128, n)
        out[name] = dict(
            max_abs_err=errs[main][f"{name}_abs"],
            max_rel_err_all_cases=max(e[name] for e in errs.values()),
            ms=graph_ms,
            ms_eager_call=ms["kernel"],
            ms_eager_call_own_plan=ms["own_plan"],
            plan_ms=plan_ms,
            plan_bytes=plan.nbytes,
            plain_ms=ms["plain"],
            library_ms=ms["library"],
            library="the einsum chain of tike_tpu's "
            + ("gather_kb_rows" if name == "usfft_gather_kb" else "scatter_kb_rows")
            + " (torch.einsum, cuBLAS, TF32 off)",
            library_flops=flops,
            library_max_rel_err=einsum_err[name],
            bound_bytes=bound["bound_bytes"],
            bound_ms=bound["bound_ms"],
            bound_by=bound["bound_by"],
            roofline_share=bound["bound_ms"] / graph_ms,
            deterministic=True,
            card=card,
        )
        log(f"[usfft] {name} at {main} ({x.shape[0]} points): kernel "
            f"{graph_ms:.4f} ms (CUDA graph, plan built beforehand; eager call "
            f"{ms['kernel']:.4f} ms, building its own plan {ms['own_plan']:.4f} ms; the plan "
            f"{plan_ms:.3f} ms, {plan.nbytes} bytes), plain {ms['plain']:.4f} ms, einsum "
            f"{ms['library']:.4f} ms ({flops:.3e} flops); bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_bytes']} bytes at {cases_usfft.HBM_BYTES_PER_S:g} B/s"
            + (f", {bound['touched_cells']} grid values touched" if bound["touched_cells"] else "")
            + f"), {100 * out[name]['roofline_share']:.1f}% of it ({card})")
        for case in timed[1:]:
            _, x_c, _, n_c, m_c, _ = inputs[case]
            plan_c, plan_ms_c = plans[case][name]
            ms_c = median_ms_in_turns(calls(case, name), reps=5)
            graph_c = graph_ms_per_call(calls(case, name)["kernel"], reps=5)
            bound_c = cases_usfft.roofline(name, x_c, n_c, m_c)
            key = (
                "admm_shape" if case == ADMM_USFFT_CASE
                else "256" if case.startswith("256") else "upsample2"
            )
            out[name].update({
                f"ms_{key}": graph_c,
                f"ms_eager_call_own_plan_{key}": ms_c["own_plan"],
                f"plan_ms_{key}": plan_ms_c,
                f"plan_bytes_{key}": plan_c.nbytes,
                f"plain_ms_{key}": ms_c["plain"],
                f"bound_ms_{key}": bound_c["bound_ms"],
                f"bound_bytes_{key}": bound_c["bound_bytes"],
            })
            log(f"[usfft] {name} at {case} ({x_c.shape[0]} points, grid {n_c}^3, m = "
                f"{m_c}): kernel {graph_c:.4f} ms (CUDA graph, plan built beforehand; eager "
                f"call building its own plan {ms_c['own_plan']:.4f} ms; the plan "
                f"{plan_ms_c:.3f} ms, {plan_c.nbytes} bytes), plain {ms_c['plain']:.4f} ms; "
                f"bound {bound_c['bound_ms']:.4f} ms ({bound_c['bound_bytes']} bytes), "
                f"{100 * bound_c['bound_ms'] / graph_c:.1f}% of it ({card})")
    return out


def lamino_volume(n: int) -> np.ndarray:
    """bench_all.py's laminography volume (seed 0): a Gaussian-windowed
    random complex n^3 volume."""
    rng = np.random.default_rng(0)
    obj = (
        rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
    ).astype(np.complex64) * np.exp(
        -((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 3) ** 2
    )
    return obj.astype(np.complex64)


def lamino_problem(device, n=cases_usfft.LAMINO_N, ntheta=cases_usfft.LAMINO_NTHETA,
                   upsample=1, kernel="kb", eps=cases_usfft.LAMINO_EPS):
    """(volume, theta, data) numpy: bench_all.py's volume and angles, the
    data simulated on ``device`` with the ``kernel`` window."""
    volume = lamino_volume(n)
    theta = cases_usfft.lamino_theta(ntheta).numpy()
    data = tl.simulate(volume, theta, cases_usfft.LAMINO_TILT, eps=eps,
                       upsample=upsample, kernel=kernel, device=device)
    return volume, theta, data


def _max_rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@contextlib.contextmanager
def gaussian_in_order(gather, scatter):
    """Inside the block the CPU's Gaussian gather and scatter are
    ``gather(Fe, plan)`` and ``scatter(f, plan)`` on a Gaussian plan of
    their points (``tests/_torch_usfft_cases.py`` writes out the kernels'
    orders), in place of the plain versions' tap scans."""
    plain = usfft.gather_gaussian_plain, usfft.scatter_gaussian_plain

    def plan(x, n, m, mu):
        return usfft.geometry_plan(x, n, m, mu, window="gaussian")

    usfft.gather_gaussian_plain = lambda Fe, x, n, m, mu: gather(Fe, plan(x, n, m, mu))
    usfft.scatter_gaussian_plain = lambda f, x, n, m, mu: scatter(f, plan(x, n, m, mu))
    try:
        yield
    finally:
        usfft.gather_gaussian_plain, usfft.scatter_gaussian_plain = plain


# The orders 25c's CGLS at upsample 1 is run in on the CPU, for the record:
# the plain version's tap scans, the first form's (the KB kernels' order on
# a Gaussian plan) and the new kernels'.
GAUSSIAN_SLICE_ORDERS = {
    "plain": contextlib.nullcontext,
    "first form": lambda: gaussian_in_order(cases_usfft.gather_sorted_plain,
                                            cases_usfft.scatter_owned_plain),
    "kernels": lambda: gaussian_in_order(cases_usfft.gather_gaussian_kernel_order,
                                         cases_usfft.scatter_gaussian_kernel_order),
}


def phase_gaussian_slice_orders(device) -> dict:
    """25c, for the record: CGLS at cg_iter 4, three outer iterations, on
    phase 10's slice with the Gaussian window at upsample 1, on the card
    and on the CPU in each of ``GAUSSIAN_SLICE_ORDERS`` and, in the plain
    order, on the data changed by 1e-7 of itself (seeds 25-27); each pair's
    largest relative cost difference and volume difference. Nothing is
    checked here (``GAUSSIAN_SLICE_RUNS`` says why)."""
    c = LAMINO_SLICE
    _, theta, data = lamino_problem("cpu", c["n"], c["ntheta"], 1, "gaussian")
    kwargs = dict(num_iter=c["num_iter"], eps=cases_usfft.LAMINO_EPS, upsample=1,
                  cg_iter=LAMINO_SLICE_CG_ITER["cgls"], kernel="gaussian")
    runs = {"card": tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, "cgls", device=device,
                                   **kwargs)}
    for name, order in GAUSSIAN_SLICE_ORDERS.items():
        with order():
            runs[f"cpu, {name}"] = tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, "cgls",
                                                  device="cpu", **kwargs)
    for seed in (25, 26, 27):
        noise = np.random.default_rng(seed).standard_normal(data.shape)
        runs[f"cpu, plain, data x (1 + 1e-7 noise {seed})"] = tl.reconstruct(
            (data * (1 + 1e-7 * noise)).astype(np.complex64), theta, cases_usfft.LAMINO_TILT,
            "cgls", device="cpu", **kwargs)
    names = list(runs)
    gaps = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            cost = float(np.max(np.abs(runs[a]["cost"] - runs[b]["cost"]) / np.abs(runs[b]["cost"])))
            gaps[f"{a} / {b}"] = (cost, _max_rel(runs[a]["obj"], runs[b]["obj"]))
            log(f"[gaussian-slice] CGLS cg_iter {kwargs['cg_iter']}, {c['num_iter']} outer "
                f"iterations, upsample 1: {a} vs {b}: costs {cost:.2e} apart, volume "
                f"{gaps[f'{a} / {b}'][1]:.2e}")
    return gaps


def phase_lamino_slices(device, upsample=LAMINO_SLICE["upsample"], kernel="kb",
                        tag="lamino-slice", runs=GAUSSIAN_SLICE_RUNS[2],
                        eps=cases_usfft.LAMINO_EPS, size=LAMINO_SLICE) -> None:
    """cgrad and CGLS on a small problem (``size``'s n and angles) with the
    ``kernel`` window, card against CPU, each of ``runs`` (algorithm,
    cg_iter, outer iterations)."""
    c = size
    volume, theta, data = lamino_problem("cpu", c["n"], c["ntheta"], upsample, kernel, eps)
    data_card = tl.simulate(volume, theta, cases_usfft.LAMINO_TILT, eps=eps,
                            upsample=upsample, kernel=kernel, device=device)
    err = _max_rel(data_card, data)
    if not err <= LAMINO_SIM_TOL:
        raise AssertionError(f"{tag}: simulate on the card differs by {err:.3e}")
    for algorithm, cg_iter, num_iter in runs:
        results = {
            str(dev): tl.reconstruct(
                data, theta, cases_usfft.LAMINO_TILT, algorithm, num_iter=num_iter,
                eps=eps, upsample=upsample, cg_iter=cg_iter, kernel=kernel, device=dev,
            )
            for dev in ("cpu", device)
        }
        ref, got = results["cpu"], results[str(device)]
        if not (np.all(np.isfinite(got["cost"])) and np.all(np.diff(got["cost"]) < 0)):
            raise AssertionError(f"{tag} {algorithm}: costs {got['cost']}")
        np.testing.assert_allclose(got["cost"], ref["cost"], rtol=LAMINO_SLICE_TOL)
        obj_err = _max_rel(got["obj"], ref["obj"])
        if not obj_err <= LAMINO_SLICE_TOL:
            raise AssertionError(f"{tag} {algorithm}: volume differs by {obj_err:.3e}")
        log(f"[{tag}] {algorithm} (cg_iter {cg_iter}), {c['n']}^3, {c['ntheta']} "
            f"angles, {kernel} window, eps {eps:g}, upsample {upsample}, {num_iter} outer "
            f"iterations on {device} "
            f"vs cpu: costs {got['cost'].tolist()} vs {ref['cost'].tolist()} (rtol "
            f"{LAMINO_SLICE_TOL:g}); volume max|err| / max|value| {obj_err:.2e}; simulate "
            f"{err:.2e}")


def phase_lamino(device, algorithm: str, card: str, problem) -> dict:
    """bench_all.py's lamino_cgrad or lamino_cgls at full width: one
    warm-up outer iteration, then LAMINO_TIMED timed ones from the start,
    with the kernel counts set to 0 just before and read just after. Then
    LAMINO_ROUNDS - 1 more timed runs for the spread, and the warm-up once
    more: the same start must give the same cost and volume bit for bit."""
    volume, theta, data = problem
    kwargs = dict(eps=cases_usfft.LAMINO_EPS, upsample=1, cg_iter=LAMINO_CG_ITER, device=device)
    tag = f"lamino-{algorithm}"

    def run(num_iter):
        start = time.perf_counter()
        result = tl.reconstruct(
            data, theta, cases_usfft.LAMINO_TILT, algorithm, num_iter=num_iter, **kwargs
        )
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    for name in usfft.LAUNCHES:
        usfft.LAUNCHES[name] = 0
    opt.HOST_READS["line_search"] = 0
    torch.cuda.reset_peak_memory_stats()
    warm, first_s = run(1)
    result, timed_s = run(LAMINO_TIMED)
    launches = dict(usfft.LAUNCHES)
    reads = opt.HOST_READS["line_search"]
    peak = torch.cuda.max_memory_allocated()
    costs = result["cost"]
    log(f"[{tag}] costs per outer iteration {costs.tolist()} (warm-up {warm['cost'].tolist()})")
    if len(costs) != LAMINO_TIMED or not np.all(np.isfinite(costs)):
        raise AssertionError(f"costs are not {LAMINO_TIMED} finite values: {costs}")
    if not (costs[-1] < costs[0] and np.all(np.diff(costs) <= 1e-6 * costs[:-1])):
        raise AssertionError(f"costs do not decrease: {costs}")
    for name in USFFT_KERNELS:
        if not launches[name] > 0:
            raise AssertionError(f"{tag} launched no {name} kernel: {launches}")
    obj = result["obj"]
    if obj.shape != volume.shape or not np.all(np.isfinite(obj)):
        raise AssertionError("reconstructed volume is not finite or has the wrong shape")
    per_iter = timed_s / LAMINO_TIMED
    more = [run(LAMINO_TIMED) for _ in range(LAMINO_ROUNDS - 1)]
    rounds = [per_iter] + [seconds / LAMINO_TIMED for _, seconds in more]
    log(f"[{tag}] {LAMINO_TIMED} outer iterations (cg_iter {LAMINO_CG_ITER}) in {timed_s:.3f} s "
        f"= {per_iter:.4f} s/iteration; first call (1 iteration) {first_s:.3f} s, so set-up "
        f"{first_s - per_iter:.3f} s ({card})")
    log(f"[{tag}] s/iteration of {LAMINO_ROUNDS} timed runs {[round(r, 5) for r in rounds]}, "
        f"median {statistics.median(rounds):.5f} ({card})")
    log(f"[{tag}] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); kernel launches "
        f"{launches}; line-search host reads {reads} ({card})")
    # Nothing on this path adds in an order that varies: the same start
    # gives the same bits, run after run.
    again, _ = run(1)
    repeats = [(again, warm, "the warm-up run twice")] + [
        (r, result, f"timed run {i + 2} against the first") for i, (r, _) in enumerate(more)
    ]
    for got, want, what in repeats:
        for key in ("cost", "obj"):
            if not np.array_equal(got[key], want[key]):
                diff = float(np.max(np.abs(got[key] - want[key])) / np.max(np.abs(want[key])))
                raise AssertionError(
                    f"{tag}: {what}: {key} differs by {diff:.3e} of the largest value from the "
                    "same start"
                )
    if not np.array_equal(costs[:1], warm["cost"]):
        raise AssertionError(f"{tag}: first timed cost {costs[0]} != warm-up's {warm['cost'][0]}")
    log(f"[{tag}] the warm-up run twice and the {LAMINO_ROUNDS} timed runs from the same start: "
        "costs and volumes bitwise equal")
    return dict(launches=launches, costs=costs, per_iter=statistics.median(rounds))


def phase_probes(device, card: str, parent_form):
    """The seven feature probes: run each once through its entry point
    (counted), each output equal to its plain version bit for bit, the odd
    shapes of gridded and prefetch likewise, then times beside the bounds:
    the kernel in a CUDA graph with its index check (a host read) left out,
    in turns with the launch floor, the library call and, for
    ``PARENT_FORM_PROBES``, the kernel in its parent's form (the library
    ``parent_form``); the eager call with the check, the plain version and
    the library call in turns."""
    inp = toolchain_probe.inputs(device)
    for name in toolchain_probe.LAUNCHES:
        toolchain_probe.LAUNCHES[name] = 0
    outputs = toolchain_probe.run(inp)
    torch.cuda.synchronize()
    launches = dict(toolchain_probe.LAUNCHES)
    toolchain_probe.check(outputs, inp)
    for name, count in launches.items():
        if count != 1:
            raise AssertionError(f"probe {name} launched {count} times: {launches}")
    # The element kernel's every lead (cx % 4) at big's edges, on the probes'
    # big and on a random narrower one.
    rng = np.random.default_rng(0)
    for big in (inp["big"], cases_probe.random_big(rng, cases_probe.BIG_SHAPES[1], device)):
        for lead in cases_probe.LEADS:
            cases_probe.check_windows(big, cases_probe.edge_corners(tuple(big.shape), lead))
    log(f"[probe] element_prefetch equal to its plain version bit for bit at every lead 0-3 at "
        f"the edges of big {list(cases_probe.BIG_SHAPES)}")
    cases_probe.check_odd_shapes(device)
    log(f"[probe] gridded at {list(cases_probe.GRIDDED_SHAPES)} (arange and random values) and "
        f"prefetch on 8 planes of {list(cases_probe.PREFETCH_PLANES)} ({', '.join(cases_probe.INDEX_KINDS)} "
        "indices): equal to their plain versions bit for bit")
    library = cases_probe.library_calls(inp)
    out = {}
    for name, fn in toolchain_probe.FUNCTIONS.items():
        args = toolchain_probe._args(name, inp)
        # The run above checked these indices.
        unchecked = {"check_indices": False} if name in toolchain_probe.INDEXED else {}
        if not torch.equal(library[name](), outputs[name]):
            raise AssertionError(f"probe {name}: the library call differs")
        ms = median_ms_in_turns({
            "plain": lambda: toolchain_probe.PLAIN[name](*args),
            "library": library[name],
            "kernel": lambda: fn(*args),
        })
        kernel = lambda: fn(*args, **unchecked)
        if not torch.equal(kernel(), outputs[name]):
            raise AssertionError(f"probe {name}: the call without the index check differs")
        fns = {"kernel": kernel, "floor": cases_probe.floor_call(name, inp), "library": library[name]}
        if name in PARENT_FORM_PROBES:

            def in_parent_form():
                with kernel_sweep.loaded("probe", parent_form):
                    return kernel()

            if not torch.equal(in_parent_form(), outputs[name]):
                raise AssertionError(f"probe {name}: the parent's form differs")
            fns["parent form"] = in_parent_form
        graph = graph_ms_in_turns(fns)
        nbytes = toolchain_probe.bound_bytes(name, inp, outputs[name])
        bound_ms = 1e3 * nbytes / cases.HBM_BYTES_PER_S
        # library_ms is one call's; prefetch's yardstick is two.
        one_call = name != "prefetch"
        out[name] = dict(
            max_abs_err=0.0,
            ms=graph["kernel"],
            ms_eager_call=ms["kernel"],
            plain_ms=ms["plain"],
            library_ms=graph["library"] if one_call else None,
            library_ms_eager_call=ms["library"] if one_call else None,
            **({} if one_call else {
                "library_two_calls_ms": graph["library"],
                "library_two_calls_ms_eager_call": ms["library"],
            }),
            library=cases_probe.LIBRARY_NAMES[name],
            bound_bytes=nbytes,
            bound_ms=bound_ms,
            bound_by="bytes",
            floor_ms=graph["floor"],
            roofline_share=bound_ms / graph["kernel"],
            deterministic=True,
            card=card,
        )
        parent = ""
        if "parent form" in graph:
            out[name]["parent_form_ms"] = graph["parent form"]
            parent = f"; the parent's form {graph['parent form']:.5f} ms (CUDA graph, same turns)"
        log(f"[probe] {name} ({toolchain_probe.PROBES[name][0]}): equal to its plain version "
            f"bit for bit; kernel {graph['kernel']:.5f} ms (CUDA graph, index check outside; eager "
            f"call {ms['kernel']:.4f} ms){parent}; launch floor (empty kernel at its grid) "
            f"{graph['floor']:.5f} ms; library ({cases_probe.LIBRARY_NAMES[name]}) "
            f"{graph['library']:.5f} ms (CUDA graph; eager {ms['library']:.4f} ms); plain "
            f"{ms['plain']:.4f} ms; bound {bound_ms:.5f} ms ({nbytes} bytes), "
            f"{100 * bound_ms / graph['kernel']:.1f}% of it ({card})")
    return launches, out


def phase_path_shapes(device, card: str) -> dict:
    """3c: the patch kernels at the ADMM and the streamed paths' shapes,
    against their plain versions (two launches bitwise equal), with each
    kernel's time beside its bound for those positions."""
    out = {}
    for name in cases.PATH_SHAPES:
        for dtype in (np.complex64, np.float32):
            image, positions, patches, p = cases.path_shape_inputs(name, device, dtype)
            label = f"{name}, {np.dtype(dtype).name}"
            errs = cases.check_patch_kernels(image, positions, patches, p, label)
            log(f"[parity] {label}: patch_fwd max|err| {errs['patch_fwd']:.3e}, patch_adj "
                f"{errs['patch_adj']:.3e}; two launches of each bitwise equal")
        image, positions, patches, p = cases.path_shape_inputs(name, device)
        shape = tuple(image.shape)
        fns = {
            "patch_fwd": lambda: patch.patch_fwd_cuda(image, positions, p),
            "patch_adj": lambda: patch.patch_adj_cuda(patches, positions, shape),
        }
        out[name] = {}
        for kernel, fn in fns.items():
            ms = graph_ms_per_call(fn, reps=10)
            bound = cases.roofline(kernel, positions, p, shape, torch.complex64)
            out[name][kernel] = dict(ms=ms, **bound)
            log(f"[parity] {kernel} at {name}: kernel {ms:.4f} ms (CUDA graph), bound "
                f"{bound['bound_ms']:.5f} ms ({bound['bound_bytes']} bytes, by "
                f"{bound['bound_by']}), {100 * bound['bound_ms'] / ms:.1f}% of it ({card})")
    return out


def _stream_slice_parameters(scan, probe, psi0, det, solver, **algo):
    options = tp.RpieOptions if solver == "rpie" else tp.LstsqOptions
    return tp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=options(
            **{"num_batch": 3, "rescale_period": 2, "batch_method": "random", **algo}
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        exitwave_options=tp.ExitWaveOptions(measured_pixels=np.ones((det, det), bool)),
    )


def _run_slice(data, params, device, epochs, store=None, history=None):
    """``iterate(epochs)`` on ``device``; ``history`` (costs, times) stands
    for epochs already run. Returns the result."""
    if history is not None:
        params.algorithm_options.costs = [[c] for c in history[0]]
        params.algorithm_options.times = list(history[1])
    with tp.Reconstruction(
        data, params, device=device, random_seed=0, store_data_on_device=store
    ) as context:
        context.iterate(epochs)
        return context.get_result()


def phase_farplane_parity(device, card: str) -> dict:
    """3d: the far-field kernel of the Gaussian model against its plain
    version (``cases_farplane.check_kernel``) on every case and at the main
    path's 1,000 x 128^2 with 1 and 3 modes; then, with every pixel
    measured as on the main path, its time and the plain chain's beside the
    bound its bytes set. The kernel writes chi over the farplane, so each
    timed call reads the last one's chi: the same bytes, finite values."""
    gaps = {}
    for name in cases_farplane.CASES:
        gaps[name] = cases_farplane.check_kernel(
            *cases_farplane.case_inputs(name, device, b=24), tag=name)
    b, d = cases_farplane.MAIN_PATTERNS, cases_farplane.MAIN_D
    out = dict(deterministic=True, card=card)
    for mode_axes in ((1, 1), (3,)):
        k = int(np.prod(mode_axes))
        data, farplane, mask = cases_farplane.inputs(mode_axes, d, True, b=b, seed=1,
                                                     device=device)
        gaps[f"{b} x {d}^2, {k} mode(s), unmeasured"] = cases_farplane.check_kernel(
            data, farplane, mask, 0.5, tag=str(mode_axes))
        data, farplane, mask = cases_farplane.inputs(mode_axes, d, False, b=b, seed=2,
                                                     device=device)
        ms = median_ms_in_turns(dict(
            plain=lambda: objective.gaussian_farplane_plain(data, farplane, mask, 1.0),
            kernel=lambda: objective.gaussian_farplane_cuda(data, farplane, mask, 1.0),
        ))
        bound_bytes = cases_farplane.bound_bytes(b, k, d)
        bound_ms = bound_bytes / cases.HBM_BYTES_PER_S * 1e3
        suffix = "" if k == 1 else f"_modes_{k}"
        out.update({
            f"ms{suffix}": ms["kernel"], f"plain_ms{suffix}": ms["plain"],
            f"bound_bytes{suffix}": bound_bytes, f"bound_ms{suffix}": bound_ms,
            f"roofline_share{suffix}": bound_ms / ms["kernel"],
        })
        log(f"[parity] farplane_gaussian {b} x {d}^2, {k} mode(s): kernel "
            f"{ms['kernel']:.4f} ms, plain ATen chain {ms['plain']:.4f} ms "
            f"({ms['plain'] / ms['kernel']:.1f}x); bound {bound_ms:.4f} ms ({bound_bytes} bytes "
            f"at {cases.HBM_BYTES_PER_S:g} B/s), {100 * bound_ms / ms['kernel']:.1f}% of it "
            f"({card})")
        del data, farplane, mask
    for name, (cost_gap, chi_gap) in gaps.items():
        log(f"[parity] farplane_gaussian {name}: costs {cost_gap:.3e}, chi {chi_gap:.3e} of the "
            f"largest magnitude (tol {cases_farplane.COST_TOL:g} / {cases_farplane.CHI_TOL:g}); "
            "chi written over the farplane, two launches bitwise equal")
    out.update(max_cost_gap=max(g[0] for g in gaps.values()),
               max_chi_gap=max(g[1] for g in gaps.values()))
    return {"farplane_gaussian": out}


def phase_stream_slices(device) -> None:
    """13a: streamed rPIE and LSQML on the card, bit for bit the resident
    run's and within SLICE_TOL of the CPU's streamed run."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(3), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu")
    for solver, num_batch in (("rpie", 3), ("lstsq", 4)):
        # The resident run takes the per-epoch path too (a finite limit),
        # the path of a streamed run.
        make = lambda: _stream_slice_parameters(
            scan, probe, psi0, det, solver, num_batch=num_batch, time_limit=1e6
        )
        resident = _run_slice(data, make(), device, 3, store=True)
        streamed = _run_slice(data, make(), device, 3, store=False)
        on_cpu = _run_slice(data, make(), "cpu", 3, store=False)
        costs = np.ravel(streamed.algorithm_options.costs)
        if not (np.all(np.isfinite(costs)) and costs[-1] < costs[0]):
            raise AssertionError(f"streamed {solver} slice: costs {costs}")
        for key in ("psi", "probe"):
            if not np.array_equal(getattr(streamed, key), getattr(resident, key)):
                diff = _max_rel(getattr(streamed, key), getattr(resident, key))
                raise AssertionError(
                    f"streamed {solver} slice: {key} differs from the resident run's by "
                    f"{diff:.3e}: the copy stream and the compute stream race"
                )
        if streamed.algorithm_options.costs != resident.algorithm_options.costs:
            raise AssertionError(f"streamed {solver} slice: costs differ from the resident run's")
        np.testing.assert_allclose(
            costs, np.ravel(on_cpu.algorithm_options.costs), rtol=SLICE_TOL
        )
        errs = {}
        for key in ("psi", "probe"):
            a, b = getattr(streamed, key), getattr(on_cpu, key)
            np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
            errs[key] = f"{_max_rel(a, b):.2e}"
        log(f"[stream-slice] {solver}, {num_batch} random batches, 3 epochs streamed on "
            f"{device}: costs {costs.tolist()}; psi, probe and costs bitwise equal to the "
            f"resident run; vs the CPU's streamed run max|err| / max|value| {errs} "
            f"(tol {SLICE_TOL:g})")


def phase_stopping_slices(device) -> None:
    """13b: the stopping rules of ``iterate``, card against CPU: a run
    that continues three epochs of tiny recorded costs sees a rising cost
    in its ``convergence_window`` and stops after the first chunk; a
    ``time_limit`` below any epoch's time stops after the first epoch."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(4), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu")
    history = ([1e-9, 2e-9, 3e-9], [0.1, 0.1, 0.1])
    cases_ = (
        ("convergence_window=4, LSQML compact, fused chunks", "lstsq",
         dict(convergence_window=4, batch_method="compact"), history, 3 + 2),
        ("convergence_window=4 with a time_limit, rPIE, per epoch", "rpie",
         dict(convergence_window=4, time_limit=1e6), history, 3 + 1),
        ("time_limit=1e-9, rPIE", "rpie", dict(time_limit=1e-9), None, 1),
    )
    for name, solver, algo, hist, want_epochs in cases_:
        runs = {
            str(dev): _run_slice(
                data, _stream_slice_parameters(scan, probe, psi0, det, solver, **algo),
                dev, 6, history=hist,
            )
            for dev in ("cpu", device)
        }
        got, ref = runs[str(device)], runs["cpu"]
        n_got, n_ref = len(got.algorithm_options.costs), len(ref.algorithm_options.costs)
        if not n_got == n_ref == want_epochs:
            raise AssertionError(
                f"{name}: the card stopped after {n_got} epochs, the CPU after {n_ref}; "
                f"expected {want_epochs}"
            )
        np.testing.assert_allclose(
            np.ravel(got.algorithm_options.costs), np.ravel(ref.algorithm_options.costs),
            rtol=SLICE_TOL,
        )
        err = _max_rel(got.psi, ref.psi)
        if not err <= SLICE_TOL:
            raise AssertionError(f"{name}: psi differs from the CPU's by {err:.3e}")
        log(f"[stop-slice] {name}: asked for 6 epochs, stopped with {n_got} recorded on "
            f"{device} and on the cpu; psi max|err| / max|value| {err:.2e} (tol {SLICE_TOL:g})")


def admm_problem(device, n, P, T, NPOS):
    """bench_all.py's admm_joint problem (seed 0), made with the port: a
    cube of refractive index in an n^3 volume, its projections at T angles
    (tilt pi/2, upsample 2) exponentiated into transmissions, and their
    diffraction data at NPOS positions under a P-pixel Gaussian probe.
    Returns (data, parameters factory, theta)."""
    rng = np.random.default_rng(0)
    k = wavenumber(ADMM_ENERGY)
    delta = 0.5 / (k * ADMM_VOXEL * n / 2)
    obj = np.zeros((n, n, n), dtype=np.complex64)
    s = slice(n // 4, 3 * n // 4)
    obj[s, s, s] = delta * (1 + 0.1j)
    theta = np.linspace(0, np.pi, T, endpoint=False).astype(np.float32)
    lines = tl.simulate(obj, theta, np.pi / 2, eps=1e-3, upsample=2, device=device) * ADMM_VOXEL
    psi_true = np.exp(1j * k * lines).astype(np.complex64)
    probe = (tp.gaussian(P) * (1 + 0j))[None, None, None].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, n - P - 3, NPOS), rng.uniform(2, n - P - 3, NPOS)], -1
    ).astype(np.float32)
    data = [
        tp.simulate(P, probe, scan, psi_true[t][None], device=device).astype(np.float32)
        for t in range(T)
    ]
    parameters = lambda: [
        tp.PtychoParameters(
            psi=np.ones((1, n, n), np.complex64),
            probe=probe.copy(),
            scan=scan.copy(),
            algorithm_options=tp.RpieOptions(num_batch=1, num_iter=1),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(init_rescale_from_measurements=False),
        )
        for _ in range(T)
    ]
    return data, parameters, theta


def _admm(data, parameters, theta, device, num_iter, obj=None):
    return tadmm.reconstruct_joint_admm(
        data, parameters, theta, obj=obj, voxelsize=ADMM_VOXEL, energy=ADMM_ENERGY,
        num_iter=num_iter, ptycho_iter=2, lamino_iter=2, device=device,
    )


def phase_admm_slice(device) -> None:
    """13c: one joint-ADMM iteration at n = 16, card against CPU: the
    costs and psi after the blend of the whole iteration, then the
    iteration's volume fit (cgrad at upsample 2, the KB kernels at m = 2
    and tilt pi/2) and re-projection from the card's phi, with the fit at
    one CG step an outer iteration, where no line-search trial is a tie."""
    data, parameters, theta = admm_problem("cpu", **ADMM_SLICE)
    runs = {str(dev): _admm(data, parameters(), theta, dev, 1) for dev in ("cpu", device)}
    got, ref = runs[str(device)], runs["cpu"]
    np.testing.assert_allclose(got["costs"], ref["costs"], rtol=SLICE_TOL)
    psi_err = max(
        _max_rel(g.psi, r.psi) for g, r in zip(got["parameters"], ref["parameters"])
    )
    obj_err = _max_rel(got["obj"], ref["obj"])
    if not psi_err <= SLICE_TOL:
        raise AssertionError(f"ADMM slice: psi after the blend differs by {psi_err:.3e}")
    if not np.all(np.isfinite(got["obj"])):
        raise AssertionError("ADMM slice: the volume is not finite")
    # Step 2 of the first iteration, where the dual is still zero.
    psi = np.stack([p.psi[0] for p in got["parameters"]])
    phi = ((-1j / wavenumber(ADMM_ENERGY)) * np.log(psi + 1e-12) / ADMM_VOXEL).astype(np.complex64)
    fits, lines = {}, {}
    for dev in ("cpu", device):
        fits[str(dev)] = tl.reconstruct(
            phi, theta, np.pi / 2, "cgrad", num_iter=2, eps=1e-3, upsample=2,
            cg_iter=LAMINO_SLICE_CG_ITER["cgrad"], device=dev,
        )
        lines[str(dev)] = tl.simulate(
            fits["cpu"]["obj"], theta, np.pi / 2, eps=1e-3, upsample=2, device=dev
        )
    fit_err = _max_rel(fits[str(device)]["obj"], fits["cpu"]["obj"])
    fwd_err = _max_rel(lines[str(device)], lines["cpu"])
    np.testing.assert_allclose(
        fits[str(device)]["cost"], fits["cpu"]["cost"], rtol=LAMINO_SLICE_TOL
    )
    if not (np.any(fits["cpu"]["obj"]) and fit_err <= LAMINO_SLICE_TOL):
        raise AssertionError(f"ADMM slice: the volume fit of phi differs by {fit_err:.3e}")
    if not fwd_err <= LAMINO_SLICE_TOL:
        raise AssertionError(f"ADMM slice: the re-projection differs by {fwd_err:.3e}")
    log(f"[admm-slice] 1 iteration at {ADMM_SLICE} on {device} vs cpu: costs {got['costs']} vs "
        f"{ref['costs']} (rtol {SLICE_TOL:g}); psi after the blend max|err| / max|value| "
        f"{psi_err:.2e} (tol {SLICE_TOL:g}); the volume fit of the card's phi at cg_iter "
        f"{LAMINO_SLICE_CG_ITER['cgrad']} (2 outer iterations, upsample 2, tilt pi/2) "
        f"{fit_err:.2e}, its costs {fits[str(device)]['cost'].tolist()} vs "
        f"{fits['cpu']['cost'].tolist()}, and the re-projection of that volume {fwd_err:.2e} "
        f"(tol {LAMINO_SLICE_TOL:g}); for information, the iteration's own volume at ADMM's "
        f"cg_iter 4, where cgrad decides trials on ties, {obj_err:.2e}")


def _reset_launches() -> None:
    """Every kernel's count to 0: the patch, the far-field, the KB, the
    Bucket, the Lanczos and the probe kernels'."""
    for counts in (
        patch.LAUNCHES, objective.LAUNCHES, usfft.LAUNCHES, bucket.LAUNCHES, interp.LAUNCHES,
        toolchain_probe.LAUNCHES,
    ):
        for name in counts:
            counts[name] = 0


def _read_launches(tag) -> dict:
    """The counts since ``_reset_launches``, the probes' under their
    ``probe_`` names; no path launches a probe, and one that did fails."""
    probes = {f"probe_{name}": count for name, count in toolchain_probe.LAUNCHES.items()}
    if any(probes.values()):
        raise AssertionError(f"{tag} launched probe kernels: {probes}")
    return {**patch.LAUNCHES, **objective.LAUNCHES, **usfft.LAUNCHES, **bucket.LAUNCHES,
            **interp.LAUNCHES, **probes}


def phase_admm(device, card: str) -> dict:
    """14: bench_all.py's admm_joint. One warm-up iteration, then
    ADMM_ROUNDS runs of ADMM_TIMED iterations, each from the warm-up's
    parameters and volume; the first run is the counted one."""
    tag = "admm"
    start = time.perf_counter()
    data, parameters, theta = admm_problem(device, **ADMM)
    log(f"[{tag}] problem {ADMM} simulated on {device} in {time.perf_counter() - start:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    warm = _admm(data, parameters(), theta, device, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    runs, seconds, plans = [], [], []
    for r in range(ADMM_ROUNDS):
        if r == 0:
            _reset_launches()
        built = LaminoPlan.built
        start = time.perf_counter()
        runs.append(_admm(data, warm["parameters"], theta, device, ADMM_TIMED, obj=warm["obj"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        plans.append(LaminoPlan.built - built)
        if r == 0:
            launches = _read_launches(tag)
    peak = torch.cuda.max_memory_allocated()
    costs = runs[0]["costs"]
    log(f"[{tag}] warm-up cost {warm['costs']}; costs of the {ADMM_TIMED} timed iterations {costs}")
    if len(costs) != ADMM_TIMED or not np.all(np.isfinite(costs)):
        raise AssertionError(f"{tag}: costs are not {ADMM_TIMED} finite values: {costs}")
    if not (costs[-1] < costs[0] and costs[0] < warm["costs"][0]):
        raise AssertionError(f"{tag}: costs do not decrease: {warm['costs']} then {costs}")
    obj = runs[0]["obj"]
    if obj.shape != (ADMM["n"],) * 3 or not np.all(np.isfinite(obj)):
        raise AssertionError(f"{tag}: the volume is not finite or has the wrong shape")
    for name in (*KERNELS, *USFFT_KERNELS):
        if not launches[name] > 0:
            raise AssertionError(f"{tag} launched no {name} kernel: {launches}")
    if plans != [1] * ADMM_ROUNDS:
        raise AssertionError(f"{tag}: LaminoPlans built per call {plans}, expected 1 each")
    for other in runs[1:]:
        same = (
            np.array_equal(other["obj"], obj)
            and other["costs"] == costs
            and all(
                np.array_equal(a.psi, b.psi) and np.array_equal(a.probe, b.probe)
                for a, b in zip(other["parameters"], runs[0]["parameters"])
            )
        )
        if not same:
            raise AssertionError(
                f"{tag}: two runs from one start differ (volume by "
                f"{_max_rel(other['obj'], obj):.3e})"
            )
    per_iter = [sec / ADMM_TIMED for sec in seconds]
    log(f"[{tag}] {ADMM_TIMED} iterations (ptycho_iter 2, lamino_iter 2, upsample 2) in "
        f"{seconds[0]:.3f} s = {per_iter[0]:.4f} s/iteration; s/iteration of {ADMM_ROUNDS} runs "
        f"{[round(x, 5) for x in per_iter]}, median {statistics.median(per_iter):.5f}; the "
        f"warm-up call (1 iteration) {first_s:.3f} s, so set-up {first_s - per_iter[0]:.3f} s "
        f"({card})")
    log(f"[{tag}] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); kernel launches of "
        f"the first timed run {launches}; LaminoPlans built per call {plans}; the "
        f"{ADMM_ROUNDS} runs from one start: volumes, psi, probes and costs bitwise equal ({card})")
    return launches


def stream_problem(n_patterns, det, hw, num_batch):
    """bench_all.py's stream_1m inputs (seed 0): uniform scan positions on
    an hw^2 object, a Gaussian probe with a phase, a constant object, and
    uniform random patterns. The patterns are a CPU float32 tensor (made by
    PyTorch's generator: 16 GB of them take numpy several times as long);
    the probe is rescaled from the data at set-up, which streams it once
    more than bench_all.py's run does."""
    rng = np.random.default_rng(0)
    scan = np.stack(
        [rng.uniform(2, hw - det - 3, n_patterns), rng.uniform(2, hw - det - 3, n_patterns)],
        -1,
    ).astype(np.float32)
    probe = (tp.gaussian(det) * np.exp(1j * 0.1 * tp.gaussian(det)))[None, None, None].astype(
        np.complex64
    )
    data = torch.rand(
        (n_patterns, det, det), dtype=torch.float32, generator=torch.Generator().manual_seed(0)
    )
    psi = np.full((1, hw, hw), 0.5 + 0j, np.complex64)
    params = lambda **algo: tp.PtychoParameters(
        probe=probe.copy(),
        psi=psi,
        scan=scan,
        algorithm_options=tp.RpieOptions(
            num_batch=num_batch, num_iter=1, batch_method="random", **algo
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(init_rescale_from_measurements=True),
    )
    return data, params


def phase_stream(device, card: str) -> dict:
    """15: bench_all.py's stream_1m, one epoch after set-up."""
    tag = "stream"
    cfg = dict(STREAM)
    while True:
        start = time.perf_counter()
        data, params = stream_problem(**cfg)
        made_s = time.perf_counter() - start
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        context = tp.Reconstruction(
            data, params(), device=device, random_seed=0, store_data_on_device=False
        )
        start = time.perf_counter()
        try:
            context.__enter__()
        except MemoryError as error:
            # Never pageable copies: a smaller size, and said so.
            log(f"[{tag}] this host cannot pin {cfg['n_patterns']} patterns ({error}); halving")
            del data, context
            cfg["n_patterns"] //= 2
            if cfg["n_patterns"] < cfg["num_batch"]:
                raise
            continue
        break
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    n = cfg["n_patterns"]
    host = context.data.host
    if host.is_cuda or not host.is_pinned():
        raise AssertionError(f"{tag}: the streamed data is not in pinned host memory")
    cut = "" if n == STREAM["n_patterns"] else f" (CUT from {STREAM['n_patterns']}: pinning failed)"
    log(f"[{tag}] {n} x {cfg['det']}^2 float32 patterns{cut} = {host.numel() * 4} bytes pinned on "
        f"the host as {tuple(host.shape)}; object {cfg['hw']}^2; made in {made_s:.2f} s; "
        f"Reconstruction entered in {setup_s:.2f} s: clustering "
        f"{context.setup_seconds['clustering']:.2f} s, pinning and filling "
        f"{context.setup_seconds['data']:.2f} s, streamed probe rescale "
        f"{context.setup_seconds['rescale']:.2f} s ({card})")
    context.data.stats()
    context.data.timing = True
    _reset_launches()
    start = time.perf_counter()
    context.iterate(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - start
    launches = _read_launches(tag)
    stats = context.data.stats()
    # A second epoch, which finds the allocator's blocks and cuFFT's plans
    # in place (bench_all.py times the first alone).
    start = time.perf_counter()
    context.iterate(1)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - start
    stats2 = context.data.stats()
    peak = torch.cuda.max_memory_allocated()
    cost, cost2 = (c[0] for c in context.get_convergence()[0])
    psi = context.get_psi()
    context.__exit__(None, None, None)
    if not np.all(np.isfinite([cost, cost2])) or not np.all(np.isfinite(psi)):
        raise AssertionError(f"{tag}: costs {cost}, {cost2} or psi are not finite")
    for name in patch.LAUNCHES:
        if not launches[name] > 0:
            raise AssertionError(f"{tag} launched no {name} kernel: {launches}")
    if stats["copies"] != cfg["num_batch"]:
        raise AssertionError(f"{tag}: {stats['copies']} copies for {cfg['num_batch']} batches")
    log(f"[{tag}] one epoch of {cfg['num_batch']} batches in {epoch_s:.3f} s = "
        f"{n / epoch_s:.1f} patterns/s; cost {cost}; kernel launches {launches} ({card})")
    rate = stats["bytes"] / (1e-3 * stats["copy_ms"]) / 1e9
    log(f"[{tag}] overlap: copy stream busy {stats['copy_ms']:.1f} ms for {stats['bytes']} bytes "
        f"in {stats['copies']} copies ({rate:.2f} GB/s), {100 * stats['copy_ms'] / (1e3 * epoch_s):.1f}% "
        f"of the epoch; compute stream waited {stats['wait_ms']:.1f} ms for copies, "
        f"{100 * stats['wait_ms'] / (1e3 * epoch_s):.1f}% of the epoch ({card})")
    log(f"[{tag}] second epoch {second_s:.3f} s = {n / second_s:.1f} patterns/s; cost {cost2}; copy stream busy "
        f"{stats2['copy_ms']:.1f} ms, compute stream waited {stats2['wait_ms']:.1f} ms ({card})")
    log(f"[{tag}] peak device memory {peak} bytes ({peak / 1e9:.3f} GB, limit "
        f"{STREAM_PEAK_LIMIT / 1e9:g} GB; the data is {host.numel() * 4 / 1e9:.1f} GB) ({card})")
    if not peak < STREAM_PEAK_LIMIT:
        raise AssertionError(f"{tag}: peak device memory {peak} bytes exceeds the limit")
    del data, context, host
    return launches


def phase_stream_compare(device, card: str) -> None:
    """bench_all.py's comparison at 100,000 patterns: the same problem
    resident and streamed, one warm-up epoch and two timed ones each. Both
    take the per-epoch path (the resident run through a finite
    ``time_limit``), so the two run the same kernels in the same order and
    their results must agree bit for bit. The resident run of the fused
    path, what a user gets by default, is timed beside them."""
    tag = "stream-compare"
    data, params = stream_problem(**STREAM_COMPARE)
    runs = {
        "resident": dict(store=True, algo=dict(time_limit=1e6)),
        "streamed": dict(store=False, algo={}),
        "resident, fused path": dict(store=True, algo={}),
    }
    out = {name: [] for name in runs}
    for name in (*runs, *reversed(runs)):
        with tp.Reconstruction(
            data, params(**runs[name]["algo"]), device=device, random_seed=0,
            store_data_on_device=runs[name]["store"],
        ) as context:
            context.iterate(1)
            torch.cuda.synchronize()
            start = time.perf_counter()
            context.iterate(2)
            torch.cuda.synchronize()
            seconds = (time.perf_counter() - start) / 2
            out[name].append((seconds, context.get_psi()))
    n = STREAM_COMPARE["n_patterns"]
    for name, results in out.items():
        times = [round(s, 5) for s, _ in results]
        log(f"[{tag}] {name}: {times} s/epoch (two runs), "
            f"{n / min(times):.1f} patterns/s at best ({card})")
        if not np.array_equal(results[0][1], results[1][1]):
            raise AssertionError(f"{tag}: two {name} runs differ")
    psi_r, psi_s = out["resident"][0][1], out["streamed"][0][1]
    if not np.array_equal(psi_r, psi_s):
        raise AssertionError(
            f"{tag}: streamed psi differs from resident by {_max_rel(psi_s, psi_r):.3e}: "
            "the copy stream and the compute stream race"
        )
    log(f"[{tag}] 3 epochs at {n} patterns, {STREAM_COMPARE['num_batch']} batches: streamed and "
        f"resident psi (both on the per-epoch path) bitwise equal; each run twice, bitwise "
        f"equal; the fused resident run differs from them by "
        f"{_max_rel(out['resident, fused path'][0][1], psi_r):.2e}")


def _bucket_parity_cases(device):
    """The Bucket kernels' parity cases: name -> (config, angles): n = 16 at
    precisions 1, 2 and 4 (16 angles over [0, pi), the ties at pi/4
    included), the golden geometry of lamino_setup (64^3, 58 angles,
    precision 1) and bench_all.py's geometry at the solver's default eps
    (128^3, precision 3) at one angle and at all 64."""
    c = cases_bucket.FULL
    out = {
        f"16^3 / 16 angles, precision {p}": (
            bucket.BucketConfig(n=16, tilt=c["tilt"], precision=p),
            cases_bucket.theta(16, 0.0, device),
        )
        for p in (1, 2, 4)
    }
    _, _, theta, tilt = cases_bucket.load_golden("lamino_setup.pickle.lzma")
    out["golden: 64^3 / 58 angles, precision 1"] = (
        bucket.BucketConfig.from_eps(64, float(tilt), 1.0),
        torch.as_tensor(np.asarray(theta, np.float32), device=device),
    )
    full = bucket.BucketConfig.from_eps(c["n"], c["tilt"], c["eps"])
    theta_full = cases_usfft.lamino_theta(c["ntheta"], device)
    out["128^3 / 1 angle, precision 3"] = (full, theta_full[5:6].contiguous())
    out["128^3 / 64 angles, precision 3"] = (full, theta_full)
    return out


def _first_form(name, cfg, values, th, trig):
    """A call of the Bucket kernel ``name`` in its first form
    (csrc/bucket_first_form.cu, the lattice) on ``values``; it reads the
    first 8 columns of the table, ``trig``."""
    lib = kernels.load("bucket_first_form")
    voxels, angles = cfg.n**3, th.shape[0]
    if name == "bucket_fwd":
        shape, entry = (angles, cfg.n, cfg.n), lib.tike_bucket_first_form_fwd
    else:
        shape, entry = (voxels,), lib.tike_bucket_first_form_adj
    out = torch.empty(shape, dtype=torch.complex64, device=values.device)
    rc = entry(values.data_ptr(), None, trig.data_ptr(), out.data_ptr(), voxels, angles, cfg.n,
               cfg.precision, bucket._weight(cfg), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} in its first form failed with CUDA error {rc}")
    return out


def phase_bucket_parity(device, card: str) -> dict:
    """16a: both Bucket kernels against their plain versions, adjointness,
    two adjoint launches bitwise equal, every point's cell equal to the
    plain version's (cases_bucket.cell_mismatches: zero) and no point
    outside its tile's window (the card's counter: zero), on each case of
    ``_bucket_parity_cases``; then each kernel's time (a CUDA graph of its
    launches on a prebuilt angle table), in turns with its first form's
    (csrc/bucket_first_form.cu, held to it first), beside its bound counted
    pipe by pipe, the first count's bound, its plain version's time (the
    index_add_ form) and, in the log only, the most global atomics the
    forward's windows allow (a bound, not a count), at the full-width and
    the golden shapes."""
    inputs = {}
    outside_total = 0  # the counter's readings over every case
    for name, (cfg, th) in _bucket_parity_cases(device).items():
        u = cases_bucket.volume(cfg.n, device=device)
        d = cases_bucket.planes(th.shape[0], cfg.n, device=device)
        e = cases_bucket.check_bucket_kernels(cfg, u, d, th)
        bucket.reset_outside_windows(device)
        cells = cases_bucket.cell_mismatches(cfg, th)
        if cells:
            raise AssertionError(f"bucket {name}: {cells} voxels' cells differ from plain")
        outside = bucket.outside_windows(device)
        if outside:
            raise AssertionError(f"bucket {name}: {outside} points outside their windows")
        outside_total += e["outside"] + outside
        inputs[name] = (cfg, th, u, d, e)
        rows, cols = bucket.window_limits(cfg)
        log(f"[bucket] {name}: fwd max|err| {e['fwd_abs']:.3e} ({e['fwd']:.2e} of max|value|; "
            f"{e['fwd_rounding']:.3f} of the rounding bound of its float32 sums, tol 1), adj "
            f"{e['adj_abs']:.3e} (bitwise equal to plain: {e['adj_bitwise']}); adjointness "
            f"{e['adjoint']:.2e} (tol {cases_bucket.ADJOINT_TOL:g}); two adjoint launches bitwise "
            f"equal; cells of "
            f"{cfg.n**3 * th.shape[0] * cfg.precision**3} points equal to plain; points outside "
            f"their tile's window {e['outside'] + outside} (windows of at most {rows} x {cols} "
            f"cells)")

    out = {}
    shapes = {"": "128^3 / 64 angles, precision 3", "_golden": "golden: 64^3 / 58 angles, precision 1"}
    for key, case in shapes.items():
        cfg, th, u, d, e = inputs[case]
        trig = bucket.bucket_trig(cfg, th)
        first_table = trig[:, : bucket.TRIG_WIDTH].contiguous()
        voxels, angles = cfg.n**3, th.shape[0]
        calls = {
            "bucket_fwd": dict(
                kernel=lambda: bucket.bucket_fwd_cuda(cfg, u, th, None, trig),
                first=lambda: _first_form("bucket_fwd", cfg, u, th, first_table),
                plain=lambda: bucket.bucket_fwd_plain(cfg, u, th, None, trig),
            ),
            "bucket_adj": dict(
                kernel=lambda: bucket.bucket_adj_cuda(cfg, d, th, None, trig),
                first=lambda: _first_form("bucket_adj", cfg, d, th, first_table),
                plain=lambda: bucket.bucket_adj_plain(cfg, d, th, None, trig),
            ),
        }
        for name, fns in calls.items():
            new, first = fns["kernel"](), fns["first"]()
            if name == "bucket_adj" and not torch.equal(new, first):
                raise AssertionError(f"bucket_adj's first form differs from the kernel at {case}")
            first_err = cases_bucket.max_rel(first, new)
            if not first_err <= 1e-4:
                raise AssertionError(f"{name}'s first form differs by {first_err:.3e} at {case}")
            graph = {}
            for turn in (("kernel", "first"), ("first", "kernel"), ("kernel", "first")):
                for which in turn:
                    graph.setdefault(which, []).append(graph_ms_per_call(fns[which], reps=3))
            graph_ms, first_ms = (statistics.median(graph[w]) for w in ("kernel", "first"))
            ms = median_ms_in_turns({k: fns[k] for k in ("kernel", "plain")}, reps=1, rounds=2)
            bound = bucket.roofline(cfg, voxels, angles, name)
            tiles = -(-cfg.n // bucket.TILE) ** 3
            rows, cols = bucket.window_limits(cfg)
            atomics = tiles * angles * rows * cols if name == "bucket_fwd" else 0
            record = {
                f"ms{key}": graph_ms,
                f"ms_eager_call{key}": ms["kernel"],
                f"parent_form_ms{key}": first_ms,
                f"plain_ms{key}": ms["plain"],
                f"bound_bytes{key}": bound["bound_bytes"],
                f"bound_fp32{key}": bound["bound_fp32"],
                f"bound_floors{key}": bound["bound_floors"],
                f"bound_bytes_ms{key}": bound["bound_bytes_ms"],
                f"bound_fp32_ms{key}": bound["bound_fp32_ms"],
                f"bound_floors_ms{key}": bound["bound_floors_ms"],
                f"bound_ms{key}": bound["bound_ms"],
                f"bound_by{key}": bound["bound_by"],
                f"bound_ms_first_count{key}": bound["bound_ms_first_count"],
                f"roofline_share{key}": bound["bound_ms"] / graph_ms,
                f"roofline_share_first_count{key}": bound["bound_ms_first_count"] / graph_ms,
                f"points{key}": bound["points"],
            }
            if not key:
                record.update(
                    max_abs_err=e[f"{name.split('_')[1]}_abs"],
                    max_rel_err_all_cases=max(
                        v[4][name.split("_")[1]] for v in inputs.values()
                    ),
                    rounding_bound_ratio_all_cases=max(
                        v[4]["fwd_rounding"] for v in inputs.values()
                    )
                    if name == "bucket_fwd"
                    else 0.0,
                    outside_windows=outside_total,
                    library_ms=None,
                    library="none: no single PyTorch call computes it; the yardstick is the "
                    "plain version (index_add_ per angle and offset for the forward, a gather "
                    "for the adjoint)",
                    deterministic=name == "bucket_adj",
                    card=card,
                )
            out.setdefault(name, {}).update(record)
            log(f"[bucket] {name} at {case} ({voxels} voxels, {bound['points']} points; float2 "
                f"atomics at most {atomics}, bounded by the window sizes, not counted): kernel {graph_ms:.4f} ms (CUDA graph; eager "
                f"{ms['kernel']:.4f} ms), first form {first_ms:.4f} ms in the same turns "
                f"({first_ms / graph_ms:.2f}x; max|diff| / max|value| {first_err:.2e}), plain "
                f"{ms['plain']:.4f} ms; bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
                f"(bytes {bound['bound_bytes']} = {bound['bound_bytes_ms']:.4f} ms at "
                f"{bucket.HBM_BYTES_PER_S:g} B/s; FP32 pipe {bound['bound_fp32']} = "
                f"{bound['bound_fp32_ms']:.4f} ms at {bucket.FP32_PER_S:g}/s; floors "
                f"{bound['bound_floors']} = {bound['bound_floors_ms']:.4f} ms at "
                f"{bucket.CONVERSIONS_PER_S:g}/s on the conversion pipe), "
                f"{100 * bound['bound_ms'] / graph_ms:.2f}% of it; the first count's bound "
                f"{bound['bound_ms_first_count']:.4f} ms, {100 * bound['bound_ms_first_count'] / graph_ms:.2f}% "
                f"({card})")
    return out


def phase_bucket_golden(device, card: str) -> None:
    """16b: the reference's golden protocol (1 + 30 outer iterations at
    eps=1 on lamino_setup) on the card, against lamino_bucket at atol
    1e-3."""
    start = time.perf_counter()
    obj, standard, costs = cases_bucket.golden_reconstruct(device)
    seconds = time.perf_counter() - start
    if not (np.all(np.isfinite(costs)) and costs[-1] < costs[0]):
        raise AssertionError(f"bucket golden: costs {costs}")
    np.testing.assert_allclose(obj, standard, atol=cases_bucket.GOLDEN_ATOL)
    err = float(np.max(np.abs(obj - standard)))
    log(f"[bucket-golden] 1 + 30 outer iterations at eps=1 on lamino_setup (64^3, 58 "
        f"angles) in {seconds:.2f} s: max|obj - lamino_bucket| {err:.3e} (atol "
        f"{cases_bucket.GOLDEN_ATOL:g}; max|lamino_bucket| {float(np.max(np.abs(standard))):.3e}); "
        f"costs {costs[0]:.6e} -> {costs[-1]:.6e} ({card})")


def phase_bucket(device, card: str) -> dict:
    """16c: Bucket laminography at full width: ``bucket.simulate`` of
    bench_all.py's volume, then ``bucket.reconstruct`` with one warm-up
    outer iteration and BUCKET_TIMED timed ones from the start, the kernel
    counts set to 0 just before the timed run and read just after."""
    c = cases_bucket.FULL
    volume = torch.as_tensor(lamino_volume(c["n"]), device=device)
    theta = cases_usfft.lamino_theta(c["ntheta"], device)
    start = time.perf_counter()
    data = tlb.simulate(volume, theta, c["tilt"], eps=c["eps"], device=device)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - start
    if tuple(data.shape) != (c["ntheta"], c["n"], c["n"]) or not bool(torch.isfinite(data).all()):
        raise AssertionError("bucket: simulated data is not finite or has the wrong shape")
    kwargs = dict(eps=c["eps"], cg_iter=c["cg_iter"], device=device)

    def run(num_iter):
        start = time.perf_counter()
        result = tlb.reconstruct(data, theta, c["tilt"], num_iter=num_iter, **kwargs)
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    opt.HOST_READS["line_search"] = 0
    torch.cuda.reset_peak_memory_stats()
    warm, first_s = run(1)
    bucket.reset_outside_windows(device)
    _reset_launches()
    result, timed_s = run(BUCKET_TIMED)
    launches = _read_launches("bucket")
    outside = bucket.outside_windows(device)
    if outside:
        raise AssertionError(f"bucket: {outside} points fell outside their tile's window")
    reads = opt.HOST_READS["line_search"]
    peak = torch.cuda.max_memory_allocated()
    costs = result["cost"]
    log(f"[bucket] costs per outer iteration {costs.tolist()} (warm-up {warm['cost'].tolist()})")
    if len(costs) != BUCKET_TIMED or not np.all(np.isfinite(costs)):
        raise AssertionError(f"bucket: costs are not {BUCKET_TIMED} finite values: {costs}")
    if not (costs[-1] < costs[0] and np.all(np.diff(costs) <= 0)):
        raise AssertionError(f"bucket: costs do not decrease: {costs}")
    for name in BUCKET_KERNELS:
        if not launches[name] > 0:
            raise AssertionError(f"bucket launched no {name} kernel: {launches}")
    obj = result["obj"]
    if tuple(obj.shape) != (c["n"],) * 3 or not bool(torch.isfinite(obj).all()):
        raise AssertionError("bucket: the volume is not finite or has the wrong shape")
    per_iter = timed_s / BUCKET_TIMED
    log(f"[bucket] simulate {tuple(data.shape)} at {c['n']}^3, precision "
        f"{bucket.BucketConfig.from_eps(c['n'], c['tilt'], c['eps']).precision}: {sim_s:.3f} s "
        f"({card})")
    log(f"[bucket] {BUCKET_TIMED} outer iterations (cg_iter {c['cg_iter']}) in {timed_s:.3f} s "
        f"= {per_iter:.4f} s/iteration; first call (1 iteration) {first_s:.3f} s, so set-up "
        f"{first_s - per_iter:.3f} s ({card})")
    log(f"[bucket] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); kernel launches "
        f"{ {k: launches[k] for k in BUCKET_KERNELS} }; line-search host reads {reads}; points "
        f"outside their tile's window {outside} ({card})")
    return dict(launches=launches, costs=costs, per_iter=per_iter)


class _LevelSpy(tpp.Reconstruction):
    """``Reconstruction`` recording, per level of a multigrid run, the
    pattern width, the set-up seconds, the seconds per epoch and the kernel
    launches (counts set to 0 at ``__enter__``, read after ``iterate``)."""

    levels: list = []

    def __enter__(self):
        _reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        super().__enter__()
        torch.cuda.synchronize()
        self._level = dict(width=int(self.data.shape[-1]), setup_s=time.perf_counter() - start)
        return self

    def iterate(self, num_iter):
        start = time.perf_counter()
        super().iterate(num_iter)
        torch.cuda.synchronize()
        self._level.update(
            epoch_s=(time.perf_counter() - start) / num_iter,
            launches=_read_launches("multigrid"),
            costs=[c[0] for c in self.parameters.algorithm_options.costs[-num_iter:]],
        )
        _LevelSpy.levels.append(self._level)


def phase_multigrid(device, scan, psi, probe, card: str) -> dict:
    """17a: ``reconstruct_multigrid`` at the main path's configuration
    (10,000 x 128^2 on 1500^2, LSQML, compact, num_batch 10), 3 levels of
    MULTIGRID_EPOCHS epochs, the data simulated on the card and cropped
    there. The positions are the main path's, those nearer than 4 px to
    the low edge moved to 4 px: at a quarter of the scale a position must
    lie 1 px inside the object (``check_allowed_positions``). Returns each
    level's launches by pattern width."""
    scan = np.maximum(scan, np.float32(2 ** (MULTIGRID_LEVELS - 1)))
    params = path_parameters(scan, psi, probe)
    params.algorithm_options.num_iter = MULTIGRID_EPOCHS
    data = tp.simulate_device(DET, probe, scan, psi, device=device)
    _LevelSpy.levels = []
    tpp.Reconstruction = _LevelSpy
    try:
        start = time.perf_counter()
        result = tp.reconstruct_multigrid(
            data, params, num_levels=MULTIGRID_LEVELS, device=device, random_seed=0
        )
        total = time.perf_counter() - start
    finally:
        tpp.Reconstruction = _LevelSpy.__bases__[0]
    levels = _LevelSpy.levels
    if [lv["width"] for lv in levels] != [DET // 4, DET // 2, DET]:
        raise AssertionError(f"multigrid ran the levels {[lv['width'] for lv in levels]}")
    costs = [c[0] for c in result.algorithm_options.costs]
    if len(costs) != MULTIGRID_LEVELS * MULTIGRID_EPOCHS or not np.all(np.isfinite(costs)):
        raise AssertionError(f"multigrid: costs {costs}")
    if result.psi.shape != psi.shape or not np.all(np.isfinite(result.psi)):
        raise AssertionError("multigrid: psi is not finite or has the wrong shape")
    out = {}
    for lv in levels:
        for name in patch.LAUNCHES:
            if not lv["launches"][name] > 0:
                raise AssertionError(f"multigrid level {lv['width']}: no {name} launch")
        if not lv["costs"][-1] < lv["costs"][0]:
            raise AssertionError(f"multigrid level {lv['width']}: costs {lv['costs']}")
        out[lv["width"]] = {k: lv["launches"][k] for k in patch.LAUNCHES}
        log(f"[multigrid] level {lv['width']}^2: set-up {lv['setup_s']:.2f} s, "
            f"{lv['epoch_s']:.4f} s/epoch ({MULTIGRID_EPOCHS} epochs), costs {lv['costs']}, "
            f"patch launches {out[lv['width']]} ({card})")
    log(f"[multigrid] {MULTIGRID_LEVELS} levels in {total:.2f} s; final cost {costs[-1]:.6e} "
        f"({card})")
    return out


def phase_ptycho_rest(device, scan, psi, probe, card: str) -> None:
    """17b-f, small sizes: config 2 with a finite time_limit (eigen probes
    on the per-epoch path) card against CPU; a checkpoint written on the
    card, loaded and resumed; ``append_new_data`` on the card against the
    CPU; ``update_positions_pd`` once, card against CPU; ``simulate`` with
    ``fly=3`` against numpy."""
    det = 24
    s_scan, s_psi, s_probe, s_psi0 = _slice_inputs(np.random.default_rng(1), _random_phase_probe)
    data = tp.simulate(det, s_probe, s_scan, s_psi, device="cpu")

    def config2_time_limit():
        p = _small_slice_parameters(s_scan, s_probe, s_psi0, det, config2=True)
        p.algorithm_options.time_limit = 60.0
        return p

    _card_vs_cpu(
        "config-2 slice with time_limit (per-epoch path, eigen probe constrained)",
        device, data, config2_time_limit, ("psi", "probe", "eigen_probe", "eigen_weights"),
    )

    # A checkpoint written on the card, loaded and resumed, against 4 epochs
    # at once.
    import tempfile

    def run(params, epochs, path=None):
        with tp.Reconstruction(data, params, device=device, random_seed=0) as context:
            context.iterate(epochs)
            if path is not None:
                checkpoint.save_parameters(path + ".live.npz", context.parameters)
            return context.get_result()

    make = lambda: _small_slice_parameters(s_scan, s_probe, s_psi0, det)  # noqa: E731
    straight = run(make(), 4)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint")
        first = run(make(), 2, path)
        checkpoint.save_parameters(path + ".npz", first)
        loaded = checkpoint.load_parameters(path + ".npz")
        live = checkpoint.load_parameters(path + ".live.npz")
    if not isinstance(loaded.psi, np.ndarray) or live.psi.shape != s_psi0.shape:
        raise AssertionError("checkpoint: loaded arrays are not numpy of the right shape")
    loaded.probe_options.init_rescale_from_measurements = False
    resumed = run(loaded, 2)
    errs = {}
    for key in ("psi", "probe", "scan"):
        a, b = getattr(resumed, key), getattr(straight, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
        errs[key] = "bitwise" if np.array_equal(a, b) else f"{_max_rel(a, b):.2e}"
    np.testing.assert_allclose(
        resumed.algorithm_options.costs, straight.algorithm_options.costs, rtol=SLICE_TOL
    )
    log(f"[checkpoint] 2 epochs on {device}, saved (from the result, and from the live device "
        f"tensors), loaded and resumed for 2: against 4 epochs at once {errs}")

    # append_new_data, card against CPU.
    results = {}
    for dev in ("cpu", device):
        p = _small_slice_parameters(s_scan[0::2], s_probe, s_psi0, det, config2=False)
        p.algorithm_options.batch_method = "wobbly_center"
        context = tp.Reconstruction(data[0::2], p, device=dev, random_seed=0)
        context.__enter__()
        context.iterate(2)
        context.append_new_data(data[1::2], s_scan[1::2])
        context.iterate(2)
        results[str(dev)] = context.get_result()
        context.__exit__(None, None, None)
    got, ref = results[str(device)], results["cpu"]
    np.testing.assert_allclose(
        got.algorithm_options.costs, ref.algorithm_options.costs, rtol=SLICE_TOL
    )
    for key in ("psi", "probe"):
        a, b = getattr(got, key), getattr(ref, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
    if got.scan.shape != s_scan.shape:
        raise AssertionError(f"append_new_data: scan {got.scan.shape}")
    log(f"[append] 2 epochs on {len(s_scan) // 2} positions, {len(s_scan) - len(s_scan) // 2} "
        f"appended, 2 more on {device} vs cpu: costs "
        f"{np.ravel(got.algorithm_options.costs).tolist()}; psi "
        f"{_max_rel(got.psi, ref.psi):.2e}, probe {_max_rel(got.probe, ref.probe):.2e}")

    # update_positions_pd, card against CPU, from positions moved off the
    # true ones.
    gen = np.random.default_rng(11)
    moved = (s_scan + gen.uniform(0.3, 0.7, s_scan.shape) * gen.choice([-1, 1], s_scan.shape))
    moved = moved.astype(np.float32)
    cfg = tpp.PtychoConfig(probe_shape=s_probe.shape[-1], detector_shape=det,
                           nz=s_psi.shape[-2], n=s_psi.shape[-1])
    outs = {}
    for dev in ("cpu", device):
        _reset_launches()
        args = [torch.as_tensor(x, device=dev) for x in (data, s_psi, s_probe, moved)]
        new_scan, cost = tp.update_positions_pd(cfg, *args)
        outs[str(dev)] = (new_scan.cpu().numpy(), cost, _read_launches("update_positions_pd"))
    (got_s, got_c, launches), (ref_s, ref_c, _) = outs[str(device)], outs["cpu"]
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=SLICE_SCAN_TOL)
    np.testing.assert_allclose(got_c, ref_c, rtol=SLICE_TOL)
    if not launches["patch_fwd"] > 0:
        raise AssertionError(f"update_positions_pd launched no patch_fwd: {launches}")
    log(f"[position-pd] update_positions_pd of {len(moved)} positions on {device} vs cpu: scan "
        f"max|err| {float(np.max(np.abs(got_s - ref_s))):.3e} px (tol {SLICE_SCAN_TOL:g}), cost "
        f"{got_c:.6e} vs {ref_c:.6e}; patch_fwd launches {launches['patch_fwd']}; mean move "
        f"{float(np.mean(np.abs(got_s - moved))):.3f} px")

    # simulate with fly=3 against numpy.
    n = 255
    got = tp.simulate(DET, probe, scan[:n], psi, fly=3, device=device)
    want = simulate_numpy(DET, probe, scan[:n], psi).reshape(n // 3, 3, DET, DET).sum(1)
    atol = SIM_ATOL * float(np.max(want))
    np.testing.assert_allclose(got, want, rtol=SIM_RTOL, atol=atol)
    log(f"[fly] simulate fly=3 of {n} positions ({got.shape[0]} exposures of {DET}^2) on "
        f"{device} vs numpy: max|err| {float(np.max(np.abs(got - want))):.3e} (rtol "
        f"{SIM_RTOL:g}, atol {atol:.3e})")


def multislice_reference_problem():
    """tests/ptycho/test_multislice_recon.py's problem: 120 positions of a
    16^2 Gaussian probe with a weak phase over 2 slices of 96^2."""
    rng = np.random.default_rng(0)
    p, hw, n = 16, 96, 120
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    psi = np.stack(
        [
            np.exp(1j * 0.4 * np.sin(5 * yy) * np.cos(3 * xx)),
            np.exp(1j * 0.3 * np.cos(4 * yy * xx * 7)),
        ]
    ).astype(np.complex64)
    probe = (tp.gaussian(p) * np.exp(1j * 0.1 * tp.gaussian(p)))[None, None, None].astype(
        np.complex64
    )
    scan = np.stack(
        [rng.uniform(2, hw - p - 3, n), rng.uniform(2, hw - p - 3, n)], -1
    ).astype(np.float32)
    return scan, psi, probe


def multislice_parameters(scan, psi0, probe, num_batch, **algo):
    """rPIE on a multislice object with MULTISLICE_OPTICS."""
    return tp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=tp.RpieOptions(num_batch=num_batch, **algo),
        object_options=tp.ObjectOptions(
            multislice_propagation_distance=MULTISLICE_OPTICS["multislice_propagation_distance"]
        ),
        probe_options=tp.ProbeOptions(
            probe_wavelength=MULTISLICE_OPTICS["probe_wavelength"],
            probe_FOV_lengths=MULTISLICE_OPTICS["probe_FOV_lengths"],
        ),
    )


def phase_multislice_slice(device) -> None:
    """18a: the multislice reference test's problem, simulated on the card
    against the CPU, then 3 rPIE epochs card against CPU (``_card_vs_cpu``,
    SLICE_TOL). The start is a perturbed 0.9 object and the probe's modulus
    with a random phase, as tests/test_torch_multislice.py holds the CPU
    path to tike_tpu from: the reference test's constant start leaves
    far-field pixels near 0, whose gradient is the phase of FFT rounding
    noise, so two FFT libraries part there by 5e-3 after 3 epochs."""
    scan, psi, probe = multislice_reference_problem()
    p = probe.shape[-1]
    data = tp.simulate(p, probe, scan, psi, device="cpu", **MULTISLICE_OPTICS)
    got = tp.simulate(p, probe, scan, psi, device=device, **MULTISLICE_OPTICS)
    atol = SIM_ATOL * float(np.max(data))
    np.testing.assert_allclose(got, data, rtol=SIM_RTOL, atol=atol)
    log(f"[multislice] simulate {psi.shape[0]} slices, {len(scan)}x{p}^2 on {device} vs cpu: "
        f"max|err| {float(np.max(np.abs(got - data))):.3e} (rtol {SIM_RTOL:g}, atol {atol:.3e})")
    gen = np.random.default_rng(3)
    psi0 = (
        0.9 + 0.05 * (gen.standard_normal(psi.shape) + 1j * gen.standard_normal(psi.shape))
    ).astype(np.complex64)
    probe0 = (np.abs(probe) * np.exp(1j * gen.uniform(-np.pi, np.pi, probe.shape))).astype(
        np.complex64
    )
    _card_vs_cpu(
        "multislice slice (2 slices of 96^2, rPIE)", device, data,
        lambda: multislice_parameters(scan, psi0, probe0, 3),
    )


def multislice_object(hw: int, slices: int) -> np.ndarray:
    """(slices, hw, hw) complex64: the main path's object recipe with other
    frequencies in each further slice (slice 0 is the main path's)."""
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    return np.stack(
        [
            np.exp(1j * 0.5 * np.sin((17 + 4 * k) * yy) * np.cos((13 - 3 * k) * xx))
            * (0.9 + 0.1 * np.cos((23 + 5 * k) * xx * yy))
            for k in range(slices)
        ]
    ).astype(np.complex64)


def _traced_epoch(context, tag: str) -> dict:
    """One more epoch of ``context`` under ``torch.profiler`` (:func:`_traced`)."""
    return _traced(lambda: context.iterate(1), tag)


def _traced(epoch, tag: str) -> dict:
    """``epoch()`` under ``torch.profiler``: the device's busy share and the
    time and launches of each kernel class (``profile_epoch``), from the
    chrome trace under ``_build/``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace = kernels.BUILD_DIR / f"epoch_trace_{tag}.json"
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        return profile_epoch.device_breakdown(json.load(f)["traceEvents"], wall * 1e6)


def phase_multislice(device, scan, probe, card: str) -> dict:
    """18b: multislice rPIE at full width: the main path's 10,000 positions,
    128^2 probe and detector and 1500^2 frame, with MULTISLICE_SLICES
    slices, rPIE with compact batches (num_batch 10), 1 probe mode, the
    optics of 18a; data simulated on the card; the main path's 0.5 start
    in every slice. ``iterate(1)`` then a timed
    ``iterate(3)`` (the kernel counts set to 0 just before, read just
    after), then one epoch traced; then the same with one slice, for the
    comparison. Costs finite and decreasing, both patch kernels launched,
    the gather preconditioners taken."""
    psi = multislice_object(HW, MULTISLICE_SLICES)
    runs, data = {}, None
    for slices in (MULTISLICE_SLICES, 1):
        tag = "multislice" if slices > 1 else "multislice-1"
        params = multislice_parameters(
            scan, np.full_like(psi[:slices], 0.5), probe, NUM_BATCH,
            batch_method="compact", num_iter=1,
        )
        runs[slices] = run = _drive(
            tag, device, probe, scan, psi, card, params, data=data, trace=slices > 1,
            **MULTISLICE_OPTICS,
        )
        data = run.pop("data")
        if (slices > 1 and run["plan"].fft_precond) or not run["fused"]:
            raise AssertionError(f"{tag}: took fft_precond {run['plan'].fft_precond}, fused "
                                 f"{run['fused']}")
    del data
    run = runs[MULTISLICE_SLICES]
    b = run["breakdown"]
    per_epoch = {k: run["launches"][k] / 3 for k in patch.LAUNCHES}
    log(f"[multislice] {MULTISLICE_SLICES} slices: {run['epoch_s']:.4f} s/epoch, "
        f"{len(scan) / run['epoch_s']:.1f} patterns/s; 1 slice, the same run: "
        f"{runs[1]['epoch_s']:.4f} s/epoch ({run['epoch_s'] / runs[1]['epoch_s']:.2f}x) ({card})")
    log(f"[multislice] kernel launches per epoch {per_epoch} ({MULTISLICE_SLICES} slices), "
        f"{ {k: runs[1]['launches'][k] / 3 for k in patch.LAUNCHES} } (1 slice)")
    classes = b["classes"]
    device_us = sum(v[0] for v in classes.values())
    log(f"[multislice] traced epoch: wall {b['wall_us'] / 1e3:.2f} ms, device busy "
        f"{b['busy_us'] / 1e3:.2f} ms, idle {100 * (1 - b['busy_us'] / b['wall_us']):.1f}%, "
        f"{b['activities']} device activities ({card})")
    for name in ("patch_fwd_kernel (ours)", "patch_adj_kernel (ours)", "cuFFT"):
        us, n = classes.get(name, (0.0, 0))
        log(f"[multislice] traced epoch: {name} {us / 1e3:.3f} ms in {n} launches "
            f"({100 * us / max(device_us, 1e-9):.1f}% of device time)")
    others = sorted(classes.items(), key=lambda kv: -kv[1][0])
    log("[multislice] traced epoch by class: " + "; ".join(
        f"{k} {v[0] / 1e3:.3f} ms / {v[1]}" for k, v in others))
    return run["launches"]


def _lanczos_calls(images, points, values, m=2) -> dict:
    """Each Lanczos kernel, its first form, its plain version and its
    library yardstick on one set of inputs."""
    h, w = images.shape[-2:]
    library = cases_interp.grid_sample_calls(images, points, values)
    return {
        "lanczos_fwd": dict(
            kernel=lambda: interp.remap_lanczos_fwd_cuda(images, points, m),
            first_form=lambda: cases_interp.first_form_fwd(images, points, m),
            plain=lambda: interp.remap_lanczos_fwd_plain(images, points, m),
            library=library["lanczos_fwd"],
        ),
        "lanczos_adj": dict(
            kernel=lambda: interp.remap_lanczos_adj_cuda(values, points, m, (h, w)),
            first_form=lambda: cases_interp.first_form_adj(values, points, m, (h, w)),
            plain=lambda: interp.remap_lanczos_adj_plain(values, points, m, (h, w)),
            library=library["lanczos_adj"],
        ),
    }


# Calls a CUDA graph captures per timing of each: the plain versions at full
# width take a tenth of a second and gigabytes of temporaries each.
LANCZOS_GRAPH_REPS = dict(kernel=20, first_form=20, plain=2, library=5)


def phase_lanczos_parity(device, card: str) -> dict:
    """19a: the Lanczos kernels against their plain versions and their own
    adjointness on every case of ``tests/_torch_interp_cases.py`` (m 0, 1,
    2, 5, 11; complex and real; a complex cval; points outside, on the edges
    and on integers; the rotation's shared points), at the paths' full
    width (128 x 1024^2: the flow warp's points and the rotation's, m = 2)
    and at the golden dataset's 128^2, there also against their first form
    (``csrc/interp_first_form.cu``) with the adjoint's fallback warps
    counted; then each kernel, its first form, its plain version and
    ``grid_sample`` (its input gradient for the adjoint) in CUDA graphs, in
    turns, at those three shapes, beside the kernel's bound."""
    errs = {name: 0.0 for name in INTERP_KERNELS}
    gap = 0.0

    def check(images, points, values, m, cval, label):
        nonlocal gap
        out = cases_interp.check_lanczos_kernels(images, points, values, m, cval, label)
        for name in INTERP_KERNELS:
            errs[name] = max(errs[name], out[name])
        gap = max(gap, out["adjointness"])
        log(f"[lanczos] {label}: lanczos_fwd max|err| {out['lanczos_fwd']:.3e}, lanczos_adj "
            f"{out['lanczos_adj']:.3e} (tol {cases_interp.FWD_TOL:g} / {cases_interp.ADJ_TOL:g} "
            f"x max|value|); adjointness {out['adjointness']:.2e} "
            f"(tol {cases_interp.ADJOINT_TOL:g})")

    for name in cases_interp.CASES:
        check(*cases_interp.case_inputs(name, device), label=name)
    full = cases_interp.full_width_inputs(device)
    values = full["images"].reshape(ALIGN_IMAGES, -1)
    golden = cases_interp.full_width_inputs(device, images=1, n=cases_interp.GOLDEN_N, seed=1)
    shapes = {
        "flow": (full["images"], full["flow"], values),
        "rotate": (full["images"], full["rotate"], values),
        "golden": (golden["images"], golden["flow"], golden["images"].reshape(1, -1)),
    }
    fallback = {}
    for key, (images, points, vals) in shapes.items():
        interp.reset_fallback_warps(device)
        check(images, points, vals, 2, 0.0, f"{tuple(images.shape)} {key} points, m = 2")
        suffix = "" if key == "flow" else f"_{key}"
        fallback[f"fallback_warps{suffix}"] = interp.fallback_warps(device)
        calls = _lanczos_calls(images, points, vals)
        for name, tol in (("lanczos_fwd", cases_interp.FWD_TOL),
                          ("lanczos_adj", cases_interp.ADJ_TOL)):
            err, rel = cases_interp._max_rel(calls[name]["kernel"](), calls[name]["first_form"]())
            log(f"[lanczos] {name} {tuple(images.shape)} {key} points against its first form: "
                f"max|err| {err:.3e} ({rel:.2e} of the largest value; tol {tol:g})")
            if not rel <= tol:
                raise AssertionError(f"{name} {key}: {rel:.3e} from its first form")
        log(f"[lanczos] lanczos_adj {tuple(images.shape)} {key} points: "
            f"{fallback[f'fallback_warps{suffix}']} of "
            f"{images.shape[0] * -(-points.shape[-2] // 32)} warps added tap by tap (their "
            f"windows' box did not fit the warp's buffer)")
    out = {name: dict(max_abs_err=errs[name], adjointness=gap, library=lib, card=card,
                      deterministic=name == "lanczos_fwd",
                      **(fallback if name == "lanczos_adj" else {}))
           for name, lib in (("lanczos_fwd", "torch.nn.functional.grid_sample (bicubic)"),
                             ("lanczos_adj", "grid_sampler_2d_backward (bicubic input grad)"))}
    for key, (images, points, vals) in shapes.items():
        for name, calls in _lanczos_calls(images, points, vals).items():
            times = {c: [] for c in calls}
            order = list(calls)
            for turn in (order, order[::-1], order):
                for c in turn:
                    times[c].append(graph_ms_per_call(calls[c], reps=LANCZOS_GRAPH_REPS[c]))
            ms = {c: statistics.median(t) for c, t in times.items()}
            bound = cases_interp.bound(name, images, points, 2)
            suffix = "" if key == "flow" else f"_{key}"
            out[name].update({
                f"ms{suffix}": ms["kernel"],
                f"first_form_ms{suffix}": ms["first_form"],
                f"plain_ms{suffix}": ms["plain"],
                f"library_ms{suffix}": ms["library"],
                f"bound_ms{suffix}": bound["bound_ms"],
                f"bound_by{suffix}": bound["bound_by"],
                f"bound_bytes{suffix}": bound["bound_bytes"],
                f"bound_fp32{suffix}": bound["bound_fp32"],
                f"roofline_share{suffix}": bound["bound_ms"] / ms["kernel"],
            })
            log(f"[lanczos] {name} {tuple(images.shape)} {key} points: kernel "
                f"{ms['kernel']:.4f} ms, first form {ms['first_form']:.4f} ms, plain "
                f"{ms['plain']:.4f} ms, library {ms['library']:.4f} "
                f"ms (CUDA graphs, in turns); bound {bound['bound_ms']:.4f} ms by "
                f"{bound['bound_by']} ({bound['bound_bytes']} bytes at "
                f"{interp.HBM_BYTES_PER_S:g} B/s, {bound['bound_fp32']} FP32 at "
                f"{interp.FP32_PER_S:g}/s), {100 * bound['bound_ms'] / ms['kernel']:.1f}% of it "
                f"({card})")
            if key != "golden" and not ms["kernel"] <= ms["first_form"]:
                raise AssertionError(
                    f"{name} {key}: {ms['kernel']:.4f} ms, slower than its first form's "
                    f"{ms['first_form']:.4f} ms")
    # A flow's filter_size of 22 (m = 11) runs m = 2's 4 x 4 window.
    images, points, _ = shapes["flow"]
    out["lanczos_fwd"]["ms_m11"] = graph_ms_per_call(
        lambda: interp.remap_lanczos_fwd_cuda(images, points, 11))
    log(f"[lanczos] lanczos_fwd {tuple(images.shape)} flow points at m = 11: "
        f"{out['lanczos_fwd']['ms_m11']:.4f} ms (m = 2: {out['lanczos_fwd']['ms']:.4f} ms; "
        f"{card})")
    return out


def phase_align_golden(device, card: str) -> None:
    """19b: ``align.simulate`` of the golden dataset (a Lanczos flow warp
    and a Fourier shift of one 128^2 image) on the card against the stored
    result, at the reference's atol."""
    with lzma.open(ALIGN_GOLDEN, "rb") as f:
        data, original, flow, shift = pickle.load(f)
    _reset_launches()
    sim = talign.simulate(
        original=original, flow=flow, shift=shift, padded_shape=None, angle=None, device=device
    )
    launches = _read_launches("align golden")
    err = float(np.max(np.abs(sim - data)))
    log(f"[align] golden {data.shape} on {device}: max|err| {err:.3e} against the stored "
        f"result (atol {ALIGN_GOLDEN_ATOL:g}); Lanczos launches "
        f"{ {k: launches[k] for k in INTERP_KERNELS} }")
    if sim.shape != data.shape or sim.dtype != np.complex64 or not err <= ALIGN_GOLDEN_ATOL:
        raise AssertionError(f"align golden: max|err| {err:.3e} > {ALIGN_GOLDEN_ATOL:g}")


def align_stack(device, images: int, n: int, seed: int = 0) -> torch.Tensor:
    """(images, n, n) complex64 band-limited random fields, made on the card
    from ``seed``: white noise through a Gaussian low-pass of 0.02 cycles
    a pixel, scaled to a largest modulus of 1."""
    gen = torch.Generator(device).manual_seed(seed)
    noise = torch.complex(
        torch.randn((images, n, n), generator=gen, device=device),
        torch.randn((images, n, n), generator=gen, device=device),
    )
    f = torch.fft.fftfreq(n, device=device)
    lowpass = torch.exp(-(f[:, None] ** 2 + f[None, :] ** 2) / (2 * 0.02**2))
    stack = torch.fft.ifft2(torch.fft.fft2(noise) * lowpass)
    return (stack / torch.abs(stack).amax()).to(torch.complex64)


def phase_align(device, card: str) -> dict:
    """19c: alignment at full width, ALIGN_IMAGES projections of ALIGN_N^2
    complex64 made on the card from seed 0, every kernel count set to 0
    before the first call and read after the last: (1) ``align.simulate``
    with a random smooth flow (filter size 5, so m = 2), random shifts of
    up to ALIGN_SHIFT px and a rotation of ALIGN_ANGLE rad; (2)
    ``align.invert`` of its result; (3) ``align.reconstruct(...,
    "cross_correlation", upsample_factor=ALIGN_UPSAMPLE)`` on the stack
    shifted alone, every shift found within ALIGN_SHIFT_TOL px; (4) the
    operator's adjoint (``ops.alignment.alignment_adj``, what a solver of
    one's own takes) at the same shift, flow and angle, held by adjointness
    against (1). Each call's seconds (numpy in and out for the entry
    points), and the Lanczos launches of each."""
    gen = np.random.default_rng(0)
    stack = align_stack(device, ALIGN_IMAGES, ALIGN_N)
    flow = cases_interp.smooth_flow(gen, ALIGN_IMAGES, ALIGN_N, device)
    shifts = gen.uniform(-ALIGN_SHIFT, ALIGN_SHIFT, (ALIGN_IMAGES, 2)).astype(np.float32)
    torch.cuda.synchronize()
    calls = {}
    _reset_launches()

    def timed(name, fn):
        before = {k: interp.LAUNCHES[k] for k in INTERP_KERNELS}
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        calls[name] = dict(
            seconds=time.perf_counter() - start,
            launches={k: interp.LAUNCHES[k] - before[k] for k in INTERP_KERNELS},
        )
        return out

    kw = dict(shift=shifts, flow=flow, angle=ALIGN_ANGLE, device=device)
    unaligned = timed("simulate", lambda: talign.simulate(stack, padded_shape=None, **kw))
    back = timed("invert", lambda: talign.invert(unaligned, unpadded_shape=None, **kw))
    shifted = talign.simulate(stack, shift=shifts, flow=None, padded_shape=None, angle=None,
                              device=device)
    found = timed("reconstruct (cross_correlation)", lambda: talign.reconstruct(
        original=stack, unaligned=shifted, algorithm="cross_correlation",
        upsample_factor=ALIGN_UPSAMPLE, device=device,
    ))
    y = torch.as_tensor(unaligned, device=device)
    aty = timed("alignment_adj", lambda: ops_alignment.alignment_adj(
        y, flow=flow, shift=torch.as_tensor(shifts, device=device), unpadded_shape=None,
        angle=ALIGN_ANGLE,
    ))
    launches = _read_launches("align")
    shape = (ALIGN_IMAGES, ALIGN_N, ALIGN_N)
    for name, value in (("simulate", unaligned), ("invert", back), ("shifted", shifted)):
        if value.shape != shape or value.dtype != np.complex64 or not np.all(np.isfinite(value)):
            raise AssertionError(f"align: {name} is not a finite complex64 {shape} array")
    err = float(np.max(np.abs(found["shift"] - shifts)))
    if found["shift"].shape != shifts.shape or not err <= ALIGN_SHIFT_TOL:
        raise AssertionError(f"align: cross_correlation missed a shift by {err:.4f} px")
    a = cases_interp.inner(y, y)
    b = cases_interp.inner(stack, aty)
    gap = abs(a - b) / abs(a)
    if not gap <= cases_interp.ADJOINT_TOL:
        raise AssertionError(f"align: <A x, A x> and <x, A* A x> differ by {gap:.3e}")
    for name in INTERP_KERNELS:
        if not launches[name] > 0:
            raise AssertionError(f"align launched no {name} kernel: {launches}")
    inner = (slice(None), slice(ALIGN_N // 4, 3 * ALIGN_N // 4), slice(ALIGN_N // 4, 3 * ALIGN_N // 4))
    x = stack.cpu().numpy()
    back_err = float(np.linalg.norm(back[inner] - x[inner]) / np.linalg.norm(x[inner]))
    for name, c in calls.items():
        log(f"[align] {name} of {shape} complex64: {c['seconds']:.3f} s, Lanczos launches "
            f"{c['launches']} ({card})")
    log(f"[align] cross_correlation at upsample {ALIGN_UPSAMPLE}: max|shift - truth| "
        f"{err:.4f} px (tol {ALIGN_SHIFT_TOL:g}) over {ALIGN_IMAGES} images of shifts up to "
        f"{ALIGN_SHIFT:g} px")
    log(f"[align] invert(simulate(x)) against x in the central half: relative error "
        f"{back_err:.3e} (the inverse of the flow and the rotation is approximate); adjointness "
        f"of the operator {gap:.2e} (tol {cases_interp.ADJOINT_TOL:g})")
    log("[align] farneback is not run on the card: it is OpenCV on the host, and the card's "
        "machine has no cv2")
    return launches


def api_parameters(scan, psi0, probe, solver, batch_method, num_batch, det, position=False):
    """Parameters of the hand-written per-epoch loop: one probe mode, the
    object and probe recovered, ``solver``'s options."""
    options = tp.RpieOptions if solver == "rpie" else tp.LstsqOptions
    return tp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=options(num_batch=num_batch, batch_method=batch_method),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        position_options=tp.PositionOptions(initial_scan=scan, update_magnitude_limit=POS_LIMIT)
        if position
        else None,
        exitwave_options=tp.ExitWaveOptions(measured_pixels=np.ones((det, det), bool)),
    )


def api_epoch(solver, params, data, batches, cfg, epoch, rng):
    """One epoch of the reference's per-epoch loop written by hand:
    ``update_preconditioners`` then ``solvers.rpie`` or
    ``solvers.lstsq_grad``."""
    fn = tp.solvers.rpie if solver == "rpie" else tp.solvers.lstsq_grad
    params = tp.update_preconditioners(cfg, params, batches)
    return fn(params, data, batches, op=cfg, epoch=epoch, rng=rng)


def api_loop(solver, params, data, batches, cfg, epochs, counted_from=None):
    """``epochs`` of :func:`api_epoch`, the batch order drawn from
    ``np.random.default_rng(0)``. With ``counted_from``, every kernel count
    is set to 0 before that epoch and the card synchronized, and the
    seconds of the epochs from there on and the counts after them are
    returned with the parameters."""
    rng = np.random.default_rng(0)
    start = None
    for epoch in range(epochs):
        if epoch == counted_from:
            torch.cuda.synchronize()
            _reset_launches()
            start = time.perf_counter()
        params = api_epoch(solver, params, data, batches, cfg, epoch, rng)
    if start is None:
        return params, None, None
    torch.cuda.synchronize()
    return params, time.perf_counter() - start, _read_launches(f"api {solver}")


def phase_api_probes(device) -> None:
    """20a: a zone-plate start: ``fresnel.single_probe`` at 128^2 with the
    original tike test's optics, split into 3 Hermite modes, their powers
    set by ``adjust_probe_power`` on the card (against the CPU); the
    multi-energy ``MW_probe``; eigen weights from
    ``simulate_varying_weights``."""
    start = time.perf_counter()
    single = tp.single_probe(probe_shape=PROBE, **API_OPTICS)
    modes = tp.add_modes_cartesian_hermite(single, MODES)
    host_s = time.perf_counter() - start
    got = tp.adjust_probe_power(torch.as_tensor(modes, device=device))
    want = tp.adjust_probe_power(modes, device="cpu")
    got = got.cpu().numpy()
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    if not (single.shape == (1, 1, 1, PROBE, PROBE) and err <= API_POWER_TOL):
        raise AssertionError(f"api: adjust_probe_power on the card differs by {err:.2e}")
    power = np.sum(np.abs(got[0, 0]) ** 2, axis=(-2, -1))
    if not np.allclose(power / power[0], 1.0 / np.arange(1, MODES + 1) ** 2, rtol=1e-5):
        raise AssertionError(f"api: adjusted mode powers {power / power[0]}")
    mw = tp.MW_probe(probe_shape=PROBE, energy=MODES, **API_OPTICS)
    mw_power = np.sum(np.abs(mw[0, 0]) ** 2, axis=(-2, -1))
    if not (mw.shape == (1, 1, MODES, PROBE, PROBE)
            and np.all(np.diff(mw_power) <= 1e-6 * mw_power[0])):
        raise AssertionError(f"api: MW_probe modes not sorted by power: {mw_power}")
    weights = tp.simulate_varying_weights(
        np.zeros((1, N_PATTERNS, 2)), np.zeros((1, 1, MODES, PROBE, PROBE)),
        rng=np.random.default_rng(0),
    )
    if not (weights.shape == (N_PATTERNS, 1, MODES) and np.all(np.abs(weights) <= 1)):
        raise AssertionError(f"api: simulate_varying_weights gave {weights.shape}")
    log(f"[api] single_probe {PROBE}^2 ({API_OPTICS['zone_plate_params']}) and "
        f"{MODES} Hermite modes on the host in {host_s:.3f} s; adjust_probe_power on the card "
        f"vs the CPU: max|err| / max|value| {err:.2e} (tol {API_POWER_TOL:g}); relative "
        f"mode powers {np.round(power / power[0], 6).tolist()}; MW_probe mode powers "
        f"{mw_power.tolist()}; simulate_varying_weights {weights.shape}")


def phase_api(device, scan, psi, probe, card: str, iterate_epoch_s: float, iterate_breakdown):
    """20b: the reference's per-epoch loop by hand at the main path's
    configuration: compact batches of the port's ``cluster`` (timed, on the
    host), data simulated on the card and stored batch-major, the probe
    rescaled to the data as ``Reconstruction``'s set-up does, then 1 + 3 epochs of
    LSQML and 1 + 3 of rPIE from the same start and batches,
    each solver's kernel counts set to 0 before its 3 timed epochs and read
    after them; then one more LSQML epoch traced, beside phase 6's traced
    epoch, and one with the card synchronized between its two calls, after
    ``update_preconditioners`` timed on parameters without probe options
    (the object's preconditioner alone).
    Returns the counts of both solvers' timed epochs together, and the
    data, the batches and the LSQML result for 20d."""
    tag = "api"
    start = time.perf_counter()
    batches = cluster.batches_padded(
        cluster.compact(scan, NUM_BATCH, rng=np.random.default_rng(0))
    )
    cluster_s = time.perf_counter() - start
    cfg = PtychoConfig(probe_shape=PROBE, detector_shape=DET, nz=HW, n=HW)
    batch_idx = torch.as_tensor(batches[0], dtype=torch.int64, device=device)
    batch_mask = torch.as_tensor(batches[1], device=device)
    data = tp.simulate_device(DET, probe, scan, psi, device=device)[batch_idx]
    torch.cuda.synchronize()
    log(f"[{tag}] compact clustering of {N_PATTERNS} positions into {NUM_BATCH} batches "
        f"{batches[0].shape} in {cluster_s:.2f} s (host); data {tuple(data.shape)} batch-major "
        f"on {device}")
    launches, results = {}, {}
    for solver in ("lstsq", "rpie"):
        params = api_parameters(
            scan, np.full_like(psi, 0.5), probe, solver, "compact", NUM_BATCH, DET
        ).copy_to_device(device)
        # The probe rescaled to the measured intensity, as Reconstruction's
        # set-up does (phase 6's among them).
        params = tpp._rescale_probe(cfg, data, batch_idx, batch_mask, params)
        params, seconds, counts = api_loop(solver, params, data, batches, cfg, 4, counted_from=1)
        costs = [c[0] for c in params.algorithm_options.costs]
        if not (len(costs) == 4 and np.all(np.isfinite(costs)) and costs[-1] < costs[0]):
            raise AssertionError(f"{tag} {solver}: costs not 4 finite, decreasing: {costs}")
        if solver == "lstsq":
            rng = np.random.default_rng(0)
            breakdown = _traced(
                lambda: api_epoch(solver, params, data, batches, cfg, 4, rng), f"{tag}-lstsq"
            )
            # The object's preconditioner alone: parameters without probe
            # options, as a caller that keeps the probe fixed passes.
            psi_only = tp.PtychoParameters(
                probe=params.probe, psi=params.psi, scan=params.scan,
                object_options=tp.ObjectOptions(),
            )
            torch.cuda.synchronize()
            start = time.perf_counter()
            tp.update_preconditioners(cfg, psi_only, batches)
            torch.cuda.synchronize()
            psi_only_s = time.perf_counter() - start
            start = time.perf_counter()
            params = tp.update_preconditioners(cfg, params, batches)
            torch.cuda.synchronize()
            precond_s = time.perf_counter() - start
            params = tp.solvers.lstsq_grad(params, data, batches, op=cfg, epoch=5, rng=rng)
            torch.cuda.synchronize()
            split = (precond_s, time.perf_counter() - start - precond_s, psi_only_s)
        for name in patch.LAUNCHES:
            if not counts[name] > 0:
                raise AssertionError(f"{tag} {solver}: no {name} launched: {counts}")
        if not bool(torch.isfinite(params.psi).all() and torch.isfinite(params.probe).all()):
            raise AssertionError(f"{tag} {solver}: the reconstruction is not finite")
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
        results[solver] = params
        log(f"[{tag}] {solver} by hand (update_preconditioners, then solvers."
            f"{'rpie' if solver == 'rpie' else 'lstsq_grad'}): costs {costs}; 3 epochs "
            f"{seconds:.3f} s = {seconds / 3:.4f} s/epoch beside phase 6's iterate "
            f"{iterate_epoch_s:.4f} s/epoch ({seconds / 3 / iterate_epoch_s:.3f}x); patch "
            f"launches { {k: counts[k] for k in patch.LAUNCHES} } ({card})")
    log_breakdown("api-main", iterate_breakdown, card)
    log_breakdown("api-lstsq", breakdown, card)
    log(f"[{tag}] lstsq by hand, one epoch synchronized between its calls: "
        f"update_preconditioners {split[0] * 1e3:.2f} ms (without probe options, the object's "
        f"alone: {split[2] * 1e3:.2f} ms), lstsq_grad {split[1] * 1e3:.2f} ms ({card})")
    return launches, dict(data=data, batches=batches, lstsq=results["lstsq"])


def phase_api_slice(device) -> None:
    """20c: the hand-written loop at phase 5's small size, card against the
    CPU: LSQML with compact batches and position correction, batch-major
    data; rPIE with wobbly-center batches, flat data."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(1), _random_phase_probe)
    det = 24
    cfg = PtychoConfig(probe_shape=16, detector_shape=det, nz=psi.shape[-2], n=psi.shape[-1])
    flat = tp.simulate(det, probe, scan, psi, device="cpu")
    for solver, method in (("lstsq", "compact"), ("rpie", "wobbly_center")):
        kw = dict(rng=np.random.default_rng(0)) if method == "compact" else {}
        batches = cluster.batches_padded(getattr(cluster, method)(scan, 3, **kw))
        data = flat[batches[0]] if solver == "lstsq" else flat
        out = {}
        for dev in ("cpu", device):
            params = api_parameters(
                scan, psi0, probe, solver, method, 3, det, position=solver == "lstsq"
            ).copy_to_device(dev)
            out[str(dev)] = api_loop(solver, params, torch.as_tensor(data, device=dev), batches,
                                     cfg, 3)[0].copy_to_host()
        got, ref = out[str(device)], out["cpu"]
        c_got = np.asarray(got.algorithm_options.costs)
        c_ref = np.asarray(ref.algorithm_options.costs)
        if not (np.all(np.isfinite(c_got)) and c_got[-1, 0] < c_got[0, 0]):
            raise AssertionError(f"api slice {solver}: costs {c_got.ravel()}")
        np.testing.assert_allclose(c_got, c_ref, rtol=SLICE_TOL)
        errs = {}
        for key in ("psi", "probe"):
            a, b = getattr(got, key), getattr(ref, key)
            np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
            errs[key] = float(np.max(np.abs(a - b)) / np.abs(b).max())
        np.testing.assert_allclose(got.scan, ref.scan, rtol=0, atol=SLICE_SCAN_TOL)
        log(f"[api] slice {solver} by hand ({method}, {'batch-major' if data.ndim == 4 else 'flat'}"
            f" data{', positions' if solver == 'lstsq' else ''}), 3 epochs on {device} vs cpu: "
            f"costs {c_got.ravel().tolist()} vs {c_ref.ravel().tolist()} (rtol {SLICE_TOL:g}); "
            f"max|err| / max|value| { {k: f'{v:.2e}' for k, v in errs.items()} }; scan max|err| "
            f"{float(np.max(np.abs(got.scan - ref.scan))):.2e} px (tol {SLICE_SCAN_TOL:g})")


def phase_api_helpers(device, scan, psi, card: str, *, data, batches, lstsq) -> None:
    """20d: ``remove_object_ambiguity`` of 20b's LSQML object;
    ``learn.extract_patches`` at every position of the 1500^2 object
    against ``patch_fwd_plain`` on the card; ``patch_fwd_padded`` to
    API_PADDED on API_WINDOWS windows; the Fourier patch pair's adjointness
    and its plain path on API_WINDOWS windows; ``get_absorbtion_image`` of
    the data, on the host."""
    tag = "api"
    pre = lstsq.object_options.preconditioner
    psi1, probe1 = tp.remove_object_ambiguity(lstsq.psi, lstsq.probe, pre)
    W = pre.real / linalg.mnorm(pre.real)
    norm = float(2 * torch.sqrt(torch.mean(torch.abs(psi1) ** 2 * W)))
    if not (abs(norm - 1) <= 1e-5 and bool(torch.isfinite(probe1).all())):
        raise AssertionError(f"{tag}: remove_object_ambiguity left a weighted norm of {norm}")
    image = torch.as_tensor(psi[0], device=device)
    positions = torch.as_tensor(scan, device=device)
    before = dict(patch.LAUNCHES)
    torch.cuda.synchronize()
    start = time.perf_counter()
    got = learn.extract_patches(image, positions, PROBE)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - start
    if not patch.LAUNCHES["patch_fwd"] == before["patch_fwd"] + 1:
        raise AssertionError(f"{tag}: extract_patches did not launch patch_fwd once")
    want = patch.patch_fwd_plain(image, positions, PROBE)
    torch.testing.assert_close(got, want, rtol=cases.FWD_TOL, atol=cases.FWD_TOL)
    extract_err = cases.max_abs(got, want)
    del got, want
    few = positions[:API_WINDOWS]
    padded = patch.patch_fwd_padded(image, few, PROBE, API_PADDED)
    pad = (API_PADDED - PROBE) // 2
    inside = padded[:, pad : pad + PROBE, pad : pad + PROBE]
    border = padded.clone()
    border[:, pad : pad + PROBE, pad : pad + PROBE] = 0
    if not (tuple(padded.shape) == (API_WINDOWS, API_PADDED, API_PADDED)
            and cases.equal_bits(inside, patch.patch_fwd(image, few, PROBE))
            and not bool(border.any())):
        raise AssertionError(f"{tag}: patch_fwd_padded is not the centred window in zeros")
    gen = torch.Generator(device).manual_seed(0)
    y = torch.complex(*torch.randn((2, API_WINDOWS, PROBE, PROBE), generator=gen, device=device))
    fwd = patch.patch_fwd_fourier(image, few, PROBE)
    adj = patch.patch_adj_fourier(y, few, (HW, HW))
    gap = abs(cases_interp.inner(fwd, y) - cases_interp.inner(image, adj)) / abs(
        cases_interp.inner(fwd, y)
    )
    lo = torch.floor(few)
    fwd_plain = shift.shift_adj(patch.patch_fwd_plain(image, lo, PROBE), few - lo)
    adj_plain = patch.patch_adj_plain(shift.shift_fwd(y, few - lo), lo, (HW, HW))
    fwd_err = cases.max_abs(fwd, fwd_plain) / cases.max_value(fwd_plain)
    adj_err = cases.max_abs(adj, adj_plain) / cases.max_value(adj_plain)
    if not (gap <= API_ADJOINT_TOL and fwd_err <= cases.FWD_TOL and adj_err <= cases.ADJ_TOL):
        raise AssertionError(
            f"{tag}: Fourier patch pair: adjointness {gap:.2e}, against its plain path "
            f"{fwd_err:.2e} / {adj_err:.2e}"
        )
    start = time.perf_counter()
    absorbtion = tp.get_absorbtion_image(data.reshape(-1, DET, DET), scan[batches[0].reshape(-1)])
    absorbtion_s = time.perf_counter() - start
    if not (absorbtion.ndim == 2 and np.all(np.isfinite(absorbtion))):
        raise AssertionError(f"{tag}: get_absorbtion_image is not a finite image")
    log(f"[{tag}] remove_object_ambiguity of the LSQML object: weighted norm {norm:.6f}; "
        f"extract_patches at {len(scan)} positions of {HW}^2 in {extract_s * 1e3:.2f} ms, "
        f"against patch_fwd_plain max|err| {extract_err:.2e} (tol {cases.FWD_TOL:g}); "
        f"patch_fwd_padded {tuple(padded.shape)}; Fourier pair on {API_WINDOWS} windows: "
        f"adjointness {gap:.2e} (tol {API_ADJOINT_TOL:g}), against its plain path "
        f"{fwd_err:.2e} / {adj_err:.2e}; get_absorbtion_image {absorbtion.shape} of "
        f"{len(scan)} patterns in {absorbtion_s:.2f} s on the host ({card})")


def _on_card_mesh(device, shards: int) -> "parallel.Mesh":
    """A 1-D mesh of ``shards`` shards, all on the card ``device``."""
    return parallel.make_mesh(devices=[device] * shards)


def phase_mesh_slice(device) -> None:
    """21a: phase 5's small LSQML slice on a mesh of two shards, on the card
    (both on cuda:0) against the same mesh on the CPU at phase 5's
    tolerance; and a one-shard mesh on the card against no mesh, bit for
    bit."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(1), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu")

    def run(dev, mesh):
        params = _small_slice_parameters(scan, probe, psi0, det)
        with tp.Reconstruction(data, params, device=dev, random_seed=0, mesh=mesh) as context:
            context.iterate(3)
            return context.get_result(), context.batches[0].shape

    ref, shape = run("cpu", parallel.make_mesh(devices=["cpu", "cpu"]))
    got, _ = run(device, _on_card_mesh(device, 2))
    c_ref = np.asarray(ref.algorithm_options.costs).ravel()
    c_got = np.asarray(got.algorithm_options.costs).ravel()
    if not (np.all(np.isfinite(c_got)) and c_got[-1] < c_got[0]):
        raise AssertionError(f"mesh slice: costs not finite and decreasing: {c_got}")
    np.testing.assert_allclose(c_got, c_ref, rtol=SLICE_TOL)
    errs = {}
    for key in ("psi", "probe"):
        a, b = getattr(got, key), getattr(ref, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
        errs[key] = float(np.max(np.abs(a - b)) / np.abs(b).max())
    log(f"[mesh-slice] 3 epochs on a mesh of 2 shards on {device} vs 2 CPU shards (batches "
        f"{shape}): costs {c_got.tolist()} vs {c_ref.tolist()} (rtol {SLICE_TOL:g}); "
        f"max|err| / max|value| { {k: f'{v:.2e}' for k, v in errs.items()} } (tol {SLICE_TOL:g})")
    none, _ = run(device, None)
    one, _ = run(device, _on_card_mesh(device, 1))
    for key in ("psi", "probe", "scan"):
        if not np.array_equal(getattr(one, key), getattr(none, key)):
            raise AssertionError(f"mesh slice: a one-shard mesh's {key} differs from no mesh's")
    if one.algorithm_options.costs != none.algorithm_options.costs:
        raise AssertionError("mesh slice: a one-shard mesh's costs differ from no mesh's")
    log(f"[mesh-slice] a one-shard mesh on {device} against no mesh: psi, probe, scan and "
        "costs bitwise equal")


# 21b against phase 6: the two runs differ by more than rounding only
# through the padding of each batch to a multiple of the mesh's size, held
# at the cross-check tolerances of the bench start
# (tests/test_torch_reconstruct.py: psi 5e-3, probe 1e-2 of the largest
# value).
MESH_PSI_TOL, MESH_PROBE_TOL = 5e-3, 1e-2


def phase_mesh_main(device, scan, psi, probe, card: str, main: dict) -> dict:
    """21b: the main path on a mesh of two shards on the card: its kernel
    counts (each patch kernel launched once per shard, twice as often as
    in phase 6), s/epoch, set-up and peak memory beside phase 6's, one
    traced epoch, and the final cost, psi and probe against phase 6's."""
    params = path_parameters(scan, psi, probe)
    out = _drive("mesh", device, probe, scan, psi, card, params, trace=True,
                 mesh=_on_card_mesh(device, 2))
    log_breakdown("mesh", out["breakdown"], card)
    launches = out["launches"]
    for name in patch.LAUNCHES:
        if launches[name] != 2 * main["launches"][name]:
            raise AssertionError(
                f"mesh: {name} launched {launches[name]} times in iterate(3), not twice phase "
                f"6's {main['launches'][name]}"
            )
    gaps = {}
    for key, tol in (("psi", MESH_PSI_TOL), ("probe", MESH_PROBE_TOL)):
        a, b = getattr(out["result"], key), getattr(main["result"], key)
        gaps[key] = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        if not gaps[key] <= tol:
            raise AssertionError(f"mesh: {key} differs from phase 6's by {gaps[key]:.3e} (tol {tol})")
    cost_gap = abs(out["costs"][-1] - main["costs"][-1]) / abs(main["costs"][-1])
    log(f"[mesh] 2 shards on {device}: {out['epoch_s']:.4f} s/epoch against phase 6's "
        f"{main['epoch_s']:.4f} ({out['epoch_s'] / main['epoch_s']:.3f}x); set-up "
        f"{out['setup_s']:.2f} s against {main['setup_s']:.2f} s; final cost "
        f"{out['costs'][-1]:.6e} against {main['costs'][-1]:.6e} (relative gap {cost_gap:.3e}); "
        f"max|diff| / max|value| psi {gaps['psi']:.3e} (tol {MESH_PSI_TOL:g}), probe "
        f"{gaps['probe']:.3e} (tol {MESH_PROBE_TOL:g}); patch launches "
        f"{ {k: launches[k] for k in patch.LAUNCHES} } against "
        f"{ {k: main['launches'][k] for k in patch.LAUNCHES} } ({card})")
    return dict(launches=dict(launches), epoch_s=out["epoch_s"])


# 21c against phase 11: tests/parallel/test_lamino_mesh.py's bound.
MESH_LAMINO_RTOL = 1e-3


def phase_mesh_lamino(device, card: str, problem, cgrad: dict) -> dict:
    """21c: phase 11's USFFT cgrad with the angles split over two shards on
    the card: 1 + LAMINO_TIMED outer iterations, the KB kernel counts of the
    timed ones (each shard's transforms launch their own), its costs against
    phase 11's at MESH_LAMINO_RTOL and its s/iteration beside phase 11's."""
    volume, theta, data = problem
    mesh = _on_card_mesh(device, 2)
    kwargs = dict(eps=cases_usfft.LAMINO_EPS, upsample=1, cg_iter=LAMINO_CG_ITER, device=device,
                  mesh=mesh)

    def run(num_iter):
        start = time.perf_counter()
        result = tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, "cgrad",
                                num_iter=num_iter, **kwargs)
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    warm, first_s = run(1)
    _reset_launches()
    result, timed_s = run(LAMINO_TIMED)
    launches = _read_launches("mesh-lamino")
    costs = result["cost"]
    if len(costs) != LAMINO_TIMED or not np.all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"mesh-lamino: costs not {LAMINO_TIMED} finite, decreasing: {costs}")
    for name in USFFT_KERNELS:
        if not launches[name] > 0:
            raise AssertionError(f"mesh-lamino launched no {name} kernel: {launches}")
    gap = float(np.max(np.abs(costs - cgrad["costs"]) / np.abs(cgrad["costs"])))
    if not gap <= MESH_LAMINO_RTOL:
        raise AssertionError(f"mesh-lamino: costs {costs} differ from phase 11's "
                             f"{cgrad['costs']} by {gap:.3e} (rtol {MESH_LAMINO_RTOL:g})")
    per_iter = timed_s / LAMINO_TIMED
    log(f"[mesh-lamino] cgrad with {theta.shape[0]} angles over 2 shards on {device}: costs "
        f"{costs.tolist()} against phase 11's {cgrad['costs'].tolist()} (max relative gap "
        f"{gap:.3e}, rtol {MESH_LAMINO_RTOL:g}); {per_iter:.4f} s/iteration against "
        f"{cgrad['per_iter']:.4f} ({per_iter / cgrad['per_iter']:.3f}x); first call "
        f"{first_s:.3f} s; KB launches { {k: launches[k] for k in USFFT_KERNELS} } against "
        f"phase 11's { {k: cgrad['launches'][k] for k in USFFT_KERNELS} } ({card})")
    return dict(launches={name: launches[name] for name in USFFT_KERNELS}, costs=costs,
                per_iter=per_iter)


def phase_mesh_bucket_slabs(device, card: str, full: dict) -> dict:
    """21d.1: the tiled Bucket kernels on the two 64-row x-slabs of 128^3 /
    64 angles / precision 3 (the two shards of obj_split=2): each against
    its plain version on the slab (the adjoint bitwise, the forward within
    the rounding bound of its sums), no point outside its window, the slabs'
    forwards summed against the full lattice's plain forward within the same
    bound; each slab kernel's time (a CUDA graph) beside the full-lattice
    kernel's per voxel."""
    c = cases_bucket.FULL
    cfg = bucket.BucketConfig.from_eps(c["n"], c["tilt"], c["eps"])
    n = cfg.n
    th = cases_usfft.lamino_theta(c["ntheta"], device)
    trig = bucket.bucket_trig(cfg, th)
    u = cases_bucket.volume(n, device=device)
    d = cases_bucket.planes(th.shape[0], n, device=device)
    total = None
    out = {name: {} for name in BUCKET_KERNELS}
    for rank in range(2):
        x0, rows = bucket.slab_of(n, 2, rank)
        part = u[x0 : x0 + rows]
        e = cases_bucket.check_bucket_kernels(cfg, part, d, th, slab=(x0, rows))
        fwd = bucket.bucket_fwd_cuda(cfg, part, th, None, trig, (x0, rows))
        total = fwd if total is None else total + fwd
        calls = {
            "bucket_fwd": lambda: bucket.bucket_fwd_cuda(cfg, part, th, None, trig, (x0, rows)),
            "bucket_adj": lambda: bucket.bucket_adj_cuda(cfg, d, th, None, trig, (x0, rows)),
        }
        for name, fn in calls.items():
            ms = statistics.median(graph_ms_per_call(fn, reps=3) for _ in range(3))
            bound = bucket.roofline(cfg, rows * n * n, th.shape[0], name)
            per_voxel = ms / (rows * n * n)
            full_per_voxel = full[name]["ms"] / n**3
            out[name].update({
                f"ms_slab{rank}": ms,
                f"bound_ms_slab{rank}": bound["bound_ms"],
                f"roofline_share_slab{rank}": bound["bound_ms"] / ms,
                f"max_abs_err_slab{rank}": e[f"{name.split('_')[1]}_abs"],
                f"outside_windows_slab{rank}": e["outside"],
            })
            log(f"[mesh-bucket] {name} on slab {(x0, rows)} of {n}^3 ({th.shape[0]} angles, "
                f"precision {cfg.precision}): {ms:.4f} ms (CUDA graph), bound "
                f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
                f"({100 * bound['bound_ms'] / ms:.1f}%); {1e6 * per_voxel:.4f} ns a voxel against "
                f"the full lattice's {1e6 * full_per_voxel:.4f} ({per_voxel / full_per_voxel:.3f}x) "
                f"({card})")
        log(f"[mesh-bucket] slab {(x0, rows)}: fwd {e['fwd_rounding']:.3f} of its rounding "
            f"bound (tol 1), adj bitwise equal to plain {e['adj_bitwise']}, points outside "
            f"windows {e['outside']}")
    torch.cuda.synchronize()
    ratio = cases_bucket.fwd_rounding_ratio(cfg, total, bucket.bucket_fwd_plain(cfg, u, th, None, trig),
                                            u, th, None, trig)
    if not ratio <= 1.0:
        raise AssertionError(f"mesh-bucket: the slabs' forwards summed differ from the full "
                             f"lattice's by {ratio:.3f} times the rounding bound")
    log(f"[mesh-bucket] the two slabs' forwards summed against the full lattice's plain forward: "
        f"{ratio:.3f} of the rounding bound of its float32 sums (tol 1) ({card})")
    return out


def phase_mesh_bucket(device, card: str, full: dict) -> dict:
    """21d.2: phase 16's Bucket problem with ``obj_split=2`` (two slabs on
    the card): 1 + BUCKET_TIMED outer iterations, costs finite and
    decreasing, the Bucket kernels launched on slabs and none outside its
    window, s/iteration beside phase 16's."""
    c = cases_bucket.FULL
    volume = torch.as_tensor(lamino_volume(c["n"]), device=device)
    theta = cases_usfft.lamino_theta(c["ntheta"], device)
    data = tlb.simulate(volume, theta, c["tilt"], eps=c["eps"], device=device)
    kwargs = dict(eps=c["eps"], cg_iter=c["cg_iter"], device=device, obj_split=2)

    def run(num_iter):
        start = time.perf_counter()
        result = tlb.reconstruct(data, theta, c["tilt"], num_iter=num_iter, **kwargs)
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    warm, first_s = run(1)
    bucket.reset_outside_windows(device)
    _reset_launches()
    result, timed_s = run(BUCKET_TIMED)
    launches = _read_launches("mesh-bucket")
    outside = bucket.outside_windows(device)
    costs = result["cost"]
    if len(costs) != BUCKET_TIMED or not np.all(np.isfinite(costs)):
        raise AssertionError(f"mesh-bucket: costs are not {BUCKET_TIMED} finite values: {costs}")
    if not (costs[-1] < costs[0] and np.all(np.diff(costs) <= 0)):
        raise AssertionError(f"mesh-bucket: costs do not decrease: {costs}")
    if outside:
        raise AssertionError(f"mesh-bucket: {outside} points fell outside their tile's window")
    for name in BUCKET_KERNELS:
        if not launches[name] > 0:
            raise AssertionError(f"mesh-bucket launched no {name} kernel: {launches}")
    if not bool(torch.isfinite(result["obj"]).all()):
        raise AssertionError("mesh-bucket: the volume is not finite")
    per_iter = timed_s / BUCKET_TIMED
    log(f"[mesh-bucket] obj_split=2 on {device}: costs {costs.tolist()} against phase 16's "
        f"{full['costs'].tolist()}; {per_iter:.4f} s/iteration against {full['per_iter']:.4f} "
        f"({per_iter / full['per_iter']:.3f}x); first call {first_s:.3f} s; launches "
        f"{ {k: launches[k] for k in BUCKET_KERNELS} } against phase 16's "
        f"{ {k: full['launches'][k] for k in BUCKET_KERNELS} }; points outside windows "
        f"{outside} ({card})")
    return dict(launches={name: launches[name] for name in BUCKET_KERNELS}, costs=costs,
                per_iter=per_iter)


def phase_mesh_bucket_golden(device, card: str) -> None:
    """21d.3: the golden protocol (phase 16b) on a 2 x 2 (data x volume)
    mesh of four shards on the card, against lamino_bucket at atol 1e-3."""
    mesh = parallel.Mesh(np.array([device] * 4, dtype=object).reshape(2, 2), ("d", "v"))
    start = time.perf_counter()
    obj, standard, costs = cases_bucket.golden_reconstruct(device, mesh=mesh)
    seconds = time.perf_counter() - start
    if not (np.all(np.isfinite(costs)) and costs[-1] < costs[0]):
        raise AssertionError(f"mesh-bucket golden: costs {costs}")
    np.testing.assert_allclose(obj, standard, atol=cases_bucket.GOLDEN_ATOL)
    err = float(np.max(np.abs(obj - standard)))
    log(f"[mesh-bucket-golden] 2 x 2 (data x volume) mesh on {device}: 1 + 30 outer iterations "
        f"in {seconds:.2f} s: max|obj - lamino_bucket| {err:.3e} (atol "
        f"{cases_bucket.GOLDEN_ATOL:g}); costs {costs[0]:.6e} -> {costs[-1]:.6e} ({card})")


SCRIPT_START = time.perf_counter()


def phase_mesh_stream_slice(device) -> None:
    """21e: phase 5's LSQML slice on two card shards, host-streamed against
    resident, both on the per-epoch path (a finite ``time_limit``): bit
    for bit."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(1), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu")
    out = {}
    for store in (True, False):
        params = _small_slice_parameters(scan, probe, psi0, det)
        params.algorithm_options.time_limit = 1e9
        with tp.Reconstruction(data, params, device=device, random_seed=0,
                               mesh=_on_card_mesh(device, 2),
                               store_data_on_device=store) as context:
            context.iterate(3)
            out[store] = context.get_result()
    for key in ("psi", "probe", "scan"):
        if not np.array_equal(getattr(out[False], key), getattr(out[True], key)):
            raise AssertionError(f"mesh stream slice: streamed {key} differs from resident")
    if out[False].algorithm_options.costs != out[True].algorithm_options.costs:
        raise AssertionError("mesh stream slice: streamed costs differ from resident")
    log(f"[mesh-stream-slice] 3 epochs on 2 card shards, streamed against resident: psi, "
        f"probe, scan and costs bitwise equal ({out[False].algorithm_options.costs})")


def _timed_context(tag, context, card, timed_stats=None) -> dict:
    """iterate(1), then iterate(3) timed with every kernel count set to 0
    just before it and read just after; the peak device memory since the
    caller reset it. ``timed_stats(True)`` starts counters just before the
    timed epochs and ``timed_stats(False)`` reads them just after (the copy
    streams' timing, or the collectives'); the reading is logged and
    returned as ``timed``."""
    start = time.perf_counter()
    context.iterate(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    if timed_stats is not None:
        timed_stats(True)
    _reset_launches()
    start = time.perf_counter()
    context.iterate(3)
    torch.cuda.synchronize()
    epoch_s = (time.perf_counter() - start) / 3
    launches = _read_launches(tag)
    timed = timed_stats(False) if timed_stats is not None else None
    costs = [c[0] for c in context.get_convergence()[0]]
    if len(costs) != 4 or not np.all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"{tag}: costs are not 4 finite decreasing values: {costs}")
    for name in patch.LAUNCHES:
        if not launches[name] > 0:
            raise AssertionError(f"{tag}: iterate(3) launched no {name} kernel: {launches}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] per-epoch costs {costs}; iterate(1) {first_s:.3f} s; iterate(3) "
        f"{epoch_s:.4f} s/epoch; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); "
        f"patch launches {({k: launches[k] for k in patch.LAUNCHES})} ({card})")
    if timed is not None:
        log(f"[{tag}] over the timed epochs, by shard or stripe: {timed} ({card})")
    return dict(launches=launches, costs=costs, epoch_s=epoch_s, peak=peak, timed=timed,
                result=context.get_result())


def _shard_stream_stats(shards):
    """A ``timed_stats`` for :func:`_timed_context` over ``shards``, the
    StreamedBatches of a streamed mesh or striped run."""
    def stats(start):
        if start:
            for s in shards:
                s.timing = True
                s.stats()
            return None
        out = [s.stats() for s in shards]
        for s in shards:
            s.timing = False
        return [{k: (round(v, 3) if isinstance(v, float) else v) for k, v in o.items()}
                for o in out]
    return stats


def _field_gaps(result, reference, keys=("psi", "probe")) -> dict:
    return {
        key: float(np.max(np.abs(getattr(result, key) - getattr(reference, key)))
                   / np.max(np.abs(getattr(reference, key))))
        for key in keys
    }


def phase_mesh_stream(device, scan, psi, probe, card: str, main: dict, data_host) -> dict:
    """21e: the main path on two card shards, streamed from host data (the
    per-epoch loop, which streaming takes): s/epoch, set-up, peak memory,
    the copy streams' times, and the final psi and probe against phase 6's
    at 21b's tolerances."""
    params = path_parameters(scan, psi, probe)
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    context = tp.Reconstruction(data_host, params, device=device, random_seed=0,
                                mesh=_on_card_mesh(device, 2), store_data_on_device=False)
    context.__enter__()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    out = _timed_context("mesh-stream", context, card, _shard_stream_stats(context.data.data))
    context.__exit__(None, None, None)
    gaps = _field_gaps(out["result"], main["result"])
    for key, tol in (("psi", MESH_PSI_TOL), ("probe", MESH_PROBE_TOL)):
        if not gaps[key] <= tol:
            raise AssertionError(f"mesh-stream: {key} differs from phase 6's by {gaps[key]:.3e}")
    log(f"[mesh-stream] 2 shards streamed on {device}: {out['epoch_s']:.4f} s/epoch against "
        f"phase 6's {main['epoch_s']:.4f}; set-up {setup_s:.2f} s "
        f"({ {k: round(v, 2) for k, v in context.setup_seconds.items()} }); final cost "
        f"{out['costs'][-1]:.6e} against {main['costs'][-1]:.6e}; max|diff| / max|value| psi "
        f"{gaps['psi']:.3e}, probe {gaps['probe']:.3e} ({card})")
    return out["launches"]


# 22b against phase 6: tests/parallel/test_striped.py's bounds for a striped
# result against the replicated one (interior correlation, final cost
# within a factor and an offset).
STRIPED_CORR, STRIPED_COST_FACTOR, STRIPED_COST_OFFSET = 0.95, 2.0, 0.05


def phase_striped_slice(device) -> None:
    """22a: ``tests/_torch_striped_cases.py``'s LSQML problem on two stripes
    of the card against two CPU stripes at phase 5's tolerance, and
    streamed against resident on the card, bit for bit."""
    psi, probe, scan, data = cases_striped.problem(n=128)
    psi0 = cases_striped.start(psi)

    def run(dev, mesh, store=True):
        params = cases_striped.parameters(tp, probe, psi0, scan, "lstsq")
        with tp.Reconstruction(data, params, device=dev, random_seed=0, mesh=mesh,
                               object_sharding="striped", store_data_on_device=store) as ctx:
            ctx.iterate(3)
            return ctx.get_result()

    ref = run("cpu", parallel.make_mesh(devices=["cpu", "cpu"]))
    got = run(device, _on_card_mesh(device, 2))
    c_ref = np.asarray(ref.algorithm_options.costs).ravel()
    c_got = np.asarray(got.algorithm_options.costs).ravel()
    if not (np.all(np.isfinite(c_got)) and c_got[-1] < c_got[0]):
        raise AssertionError(f"striped slice: costs not finite and decreasing: {c_got}")
    np.testing.assert_allclose(c_got, c_ref, rtol=SLICE_TOL)
    errs = {}
    for key in ("psi", "probe"):
        a, b = getattr(got, key), getattr(ref, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
        errs[key] = float(np.max(np.abs(a - b)) / np.abs(b).max())
    log(f"[striped-slice] 3 epochs on 2 stripes on {device} vs 2 CPU stripes: costs "
        f"{c_got.tolist()} vs {c_ref.tolist()} (rtol {SLICE_TOL:g}); max|err| / max|value| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol {SLICE_TOL:g})")
    streamed = run(device, _on_card_mesh(device, 2), store=False)
    for key in ("psi", "probe", "scan"):
        if not np.array_equal(getattr(streamed, key), getattr(got, key)):
            raise AssertionError(f"striped slice: streamed {key} differs from resident")
    if streamed.algorithm_options.costs != got.algorithm_options.costs:
        raise AssertionError("striped slice: streamed costs differ from resident")
    log(f"[striped-slice] streamed against resident on {device}: psi, probe, scan and costs "
        "bitwise equal")


def _drive_striped(tag, device, params, data_host, card, store=True, trace=False) -> dict:
    """Enter a striped Reconstruction of ``params`` on two stripes of the
    card and run :func:`_timed_context`, and with ``trace`` one more epoch
    traced; returns its record with the set-up's seconds and the stripe
    geometry."""
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    context = tp.Reconstruction(data_host, params, device=device, random_seed=0,
                                mesh=_on_card_mesh(device, 2), object_sharding="striped",
                                store_data_on_device=store)
    context.__enter__()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    state = context._striped
    plan = state.plan
    window = tuple(state.states[0].psi.shape)
    log(f"[{tag}] entered in {setup_s:.2f} s "
        f"({ {k: round(v, 2) for k, v in context.setup_seconds.items()} }): hs "
        f"{plan.stripe_height}, halo {plan.halo}, windows {window} complex64 "
        f"({np.prod(window) * 8 / 1e6:.1f} MB each), positions a stripe "
        f"{plan.counts.tolist()}, batches {tuple(state.batch_idx[0].shape)} a stripe, "
        f"fft_precond {state.epoch_plan.fft_precond} ({card})")
    stats = None if store else _shard_stream_stats(state.data)
    out = _timed_context(tag, context, card, stats)
    if trace:
        log_breakdown(tag, _traced_epoch(context, tag), card)
    context.__exit__(None, None, None)
    result = out["result"]
    if result.psi.shape != params.psi.shape or not np.all(np.isfinite(result.psi)):
        raise AssertionError(f"{tag}: stitched psi is not finite or has the wrong shape")
    out.update(setup_s=setup_s, plan=plan, window=window)
    return out


def phase_striped(device, scan, psi, probe, card: str, main: dict, data_host) -> dict:
    """22b and 22c: the main path's LSQML striped over two stripes of the
    card, resident and host-streamed, and rPIE resident; the halo
    cross-fade's time. Returns each run's kernel counts."""
    started = time.perf_counter()
    lsq = _drive_striped("striped", device, path_parameters(scan, psi, probe), data_host, card,
                         trace=True)
    plan = lsq["plan"]
    # hs = ceil(H / 2) and halo = P + 1 + 8: at the main path's width 750,
    # 137 and windows of 1024 x 1500.
    hs, halo = -(-psi.shape[-2] // 2), probe.shape[-1] + 9
    if (plan.stripe_height, plan.halo, lsq["window"][-2:]) != (
        hs, halo, (hs + 2 * halo, psi.shape[-1])
    ):
        raise AssertionError(f"striped: geometry {plan} {lsq['window']} is not the expected")
    corr = cases_striped.interior_correlation(lsq["result"].psi, main["result"].psi)
    bound = STRIPED_COST_FACTOR * max(main["costs"][-1], 1e-3) + STRIPED_COST_OFFSET
    if not corr > STRIPED_CORR:
        raise AssertionError(f"striped: interior correlation with phase 6 {corr:.6f}")
    if not lsq["costs"][-1] < bound:
        raise AssertionError(f"striped: final cost {lsq['costs'][-1]} >= {bound}")
    log(f"[striped] 2 stripes on {device}: {lsq['epoch_s']:.4f} s/epoch against phase 6's "
        f"{main['epoch_s']:.4f} ({lsq['epoch_s'] / main['epoch_s']:.3f}x); set-up "
        f"{lsq['setup_s']:.2f} s against phase 6's {main['setup_s']:.2f} s; final cost "
        f"{lsq['costs'][-1]:.6e} against phase 6's {main['costs'][-1]:.6e} (bound {bound:.4g}); "
        f"interior correlation of psi with phase 6's {corr:.6f} (> {STRIPED_CORR}) ({card})")
    streamed = _drive_striped("striped-stream", device, path_parameters(scan, psi, probe),
                              data_host, card, store=False)
    gaps = _field_gaps(streamed["result"], lsq["result"])
    np.testing.assert_allclose(streamed["costs"], lsq["costs"], rtol=SLICE_TOL)
    for key, gap in gaps.items():
        if not gap <= SLICE_TOL:
            raise AssertionError(f"striped-stream: {key} differs from resident by {gap:.3e}")
    log(f"[striped-stream] {streamed['epoch_s']:.4f} s/epoch against resident "
        f"{lsq['epoch_s']:.4f}; set-up {streamed['setup_s']:.2f} s; peak "
        f"{streamed['peak'] / 2**30:.3f} GiB against {lsq['peak'] / 2**30:.3f} GiB; "
        f"max|diff| / max|value| against resident psi {gaps['psi']:.3e}, probe "
        f"{gaps['probe']:.3e} (tol {SLICE_TOL:g}) ({card})")
    rpie_params = path_parameters(scan, psi, probe)
    rpie_params.algorithm_options = tp.RpieOptions(
        num_batch=NUM_BATCH, num_iter=1, batch_method="compact"
    )
    rpie = _drive_striped("striped-rpie", device, rpie_params, data_host, card)
    log(f"[striped-rpie] {rpie['epoch_s']:.4f} s/epoch; set-up {rpie['setup_s']:.2f} s; peak "
        f"{rpie['peak'] / 2**30:.3f} GiB ({card})")
    # 22c: the cross-fade of one stripe's seams at the windows' shape.
    window = torch.ones((1, *lsq["window"][-2:]), dtype=torch.complex64, device=device)
    seams = torch.ones((2, 2, 1, 2 * plan.halo, window.shape[-1]), dtype=torch.complex64,
                       device=device)
    blend_ms = _events_ms(
        lambda: parallel_halo.cross_fade(window, seams, 0, plan.stripe_height, plan.halo)
    )
    log(f"[striped] cross-fade of one window {tuple(window.shape)}: {blend_ms:.4f} ms a "
        f"stripe, once an epoch, against {lsq['epoch_s'] * 1e3:.1f} ms an epoch ({card})")
    log(f"[striped] phase 22b-c took {time.perf_counter() - started:.1f} s ({card})")
    return dict(striped=lsq["launches"], striped_stream=streamed["launches"],
                striped_rpie=rpie["launches"]), lsq


# 23: two processes on the one card. NCCL refuses two ranks on one device,
# so the workers join a gloo group, which the mesh's collectives stage
# through page-locked host memory.
DIST_WORLD, DIST_TIMEOUT_S, DIST_DEVICE = 2, 480, "cuda:0"
# The check of gloo's all_gather on CUDA tensors sends this many bytes a
# rank, about the mean part of 23b's exchanges, and times this many calls.
GLOO_CHECK_BYTES, GLOO_CHECK_REPEATS = 2**22, 10
# 23b and 23c against one process running the same global program (the
# largest |psi|), and 23d's costs against 21c's and the parent's Bucket run:
# the runs are the same programs, so the gaps should be 0 (each is logged);
# the Bucket forward's float atomics round differently from run to run, so
# 23d holds both at MESH_LAMINO_RTOL, and the Bucket solver at cg_iter
# DIST_BUCKET_CG_ITER, where nine runs of the same projections on the card
# were equal bit for bit; at the problem's cg_iter 4 they spread by 1.29e-3
# (ROADMAP.md section 3).
DIST_PSI_TOL = 1e-5
DIST_BUCKET_CG_ITER, DIST_BUCKET_REPEATS = 1, 9


def _dist_slice(mesh, device, single):
    """23a's run: phase 5's small LSQML slice in the multi-process layout,
    each process from its ``stripe_for_process`` rows, or in one process
    (``_force_stripes=2``) from all of them."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(1), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu")
    kw = dict(_force_stripes=2) if single else {}
    if not single:
        data = data[distributed.stripe_for_process(scan)]
    params = _small_slice_parameters(scan, probe, psi0, det)
    with tp.Reconstruction(data, params, device=device, random_seed=0, mesh=mesh,
                           **kw) as context:
        context.iterate(3)
        result = context.get_result()
    return {"psi": result.psi, "probe": result.probe, "scan": result.scan,
            "costs": np.asarray(result.algorithm_options.costs, np.float64).ravel()}


def _dist_context(tag, context, card) -> tuple:
    """Enter ``context`` and run :func:`_timed_context`, the collectives
    counted over the timed epochs; returns (record, arrays)."""
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    context.__enter__()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    setup_parts = {k: round(v, 3) for k, v in context.setup_seconds.items()}
    def collectives(start):
        if start:
            parallel.collective_stats.reset()
            return None
        return parallel.collective_stats.as_dict()

    out = _timed_context(tag, context, card, collectives)
    stats = out["timed"]
    context.__exit__(None, None, None)
    result = out["result"]
    record = dict(
        epoch_s=out["epoch_s"], setup_s=setup_s, setup_parts=setup_parts, peak=out["peak"],
        costs=out["costs"], launches=out["launches"],
        collective_ms_epoch=stats["ms"] / 3, collective_bytes_epoch=stats["bytes"] / 3,
        collective_calls_epoch=stats["calls"] / 3,
    )
    return record, {"psi": result.psi, "probe": result.probe, "scan": result.scan}


def _dist_bucket_reference(mesh, device, card) -> dict:
    """23d's Bucket reference in one process: phase 16's projections,
    simulated once (the workers take the same ones), and the solver on
    ``mesh`` for BUCKET_TIMED outer iterations, DIST_BUCKET_REPEATS times
    at DIST_BUCKET_CG_ITER and as often at the problem's cg_iter, each
    set's spread logged. The first run at DIST_BUCKET_CG_ITER is the
    reference; its repeats must stay within MESH_LAMINO_RTOL of it."""
    c = cases_bucket.FULL
    volume = torch.as_tensor(lamino_volume(c["n"]), device=device)
    theta = cases_usfft.lamino_theta(c["ntheta"], device)
    data = tlb.simulate(volume, theta, c["tilt"], eps=c["eps"], device=device)
    runs = {}
    for cg_iter in (DIST_BUCKET_CG_ITER, c["cg_iter"]):
        costs = np.asarray([
            tlb.reconstruct(data, theta, c["tilt"], num_iter=BUCKET_TIMED, eps=c["eps"],
                            cg_iter=cg_iter, device=device, mesh=mesh)["cost"]
            for _ in range(DIST_BUCKET_REPEATS)
        ])
        runs[cg_iter] = float(np.max(np.abs(costs - costs[0]) / np.abs(costs[0])))
        if cg_iter == DIST_BUCKET_CG_ITER:
            reference = costs[0].tolist()
    log(f"[dist-bucket] one process on 2 shards of {device}, {DIST_BUCKET_REPEATS} runs of the "
        f"same projections: max relative spread of the costs {runs} by cg_iter; the reference "
        f"(cg_iter {DIST_BUCKET_CG_ITER}) {reference} ({card})")
    if not runs[DIST_BUCKET_CG_ITER] <= MESH_LAMINO_RTOL:
        raise AssertionError(f"23d bucket: one process's runs spread by {runs}")
    return dict(data=data.cpu().numpy(), costs=reference)


def _dist_lamino(mesh, device, card, rank, bucket_data):
    """23d: phase 11's cgrad (1 + LAMINO_TIMED outer iterations) with each
    process's contiguous half of the angles, and phase 16's Bucket problem
    on ``bucket_data`` (the parent's projections) with the volume's
    x-slabs over the processes: 1 + BUCKET_TIMED timed outer iterations at
    the problem's cg_iter, then BUCKET_TIMED at DIST_BUCKET_CG_ITER for the
    comparison with the parent's run; between them 25d's Gaussian cgrad on
    this process's angles. Returns the three runs' records."""
    volume, theta, data = lamino_problem(device)
    data, theta = distributed.split_for_process(data, theta)
    kwargs = dict(eps=cases_usfft.LAMINO_EPS, upsample=1, cg_iter=LAMINO_CG_ITER, device=device,
                  mesh=mesh)
    tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, "cgrad", num_iter=1, **kwargs)
    _reset_launches()
    parallel.collective_stats.reset()
    start = time.perf_counter()
    result = tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, "cgrad",
                            num_iter=LAMINO_TIMED, **kwargs)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - start) / LAMINO_TIMED
    lamino = dict(costs=np.asarray(result["cost"]).tolist(), per_iter=per_iter,
                  launches=_read_launches("dist-lamino"),
                  collectives=parallel.collective_stats.as_dict())
    log(f"[dist-lamino] rank {rank}: {theta.shape[0]} angles, {per_iter:.4f} s/iteration, "
        f"costs {lamino['costs']}, collectives {lamino['collectives']} ({card})")
    _reset_launches()
    result = tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, "cgrad",
                            **{**kwargs, **GAUSSIAN_MESH_KWARGS})
    gaussian = dict(costs=np.asarray(result["cost"]).tolist(),
                    launches=_read_launches("dist-gaussian"))
    log(f"[dist-gaussian] rank {rank}: {theta.shape[0]} angles, costs {gaussian['costs']} "
        f"({card})")
    c = cases_bucket.FULL
    theta = cases_usfft.lamino_theta(c["ntheta"], device)
    data = torch.as_tensor(bucket_data)
    kwargs = dict(eps=c["eps"], cg_iter=c["cg_iter"], device=device, mesh=mesh)
    tlb.reconstruct(data, theta, c["tilt"], num_iter=1, **kwargs)
    bucket.reset_outside_windows(device)
    _reset_launches()
    parallel.collective_stats.reset()
    start = time.perf_counter()
    result = tlb.reconstruct(data, theta, c["tilt"], num_iter=BUCKET_TIMED, **kwargs)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - start) / BUCKET_TIMED
    slabs = dict(costs=np.asarray(result["cost"]).tolist(), per_iter=per_iter,
                 launches=_read_launches("dist-bucket"),
                 outside=int(bucket.outside_windows(device)),
                 collectives=parallel.collective_stats.as_dict())
    held = tlb.reconstruct(data, theta, c["tilt"], num_iter=BUCKET_TIMED,
                           **{**kwargs, "cg_iter": DIST_BUCKET_CG_ITER})
    slabs["held_costs"] = np.asarray(held["cost"]).tolist()
    log(f"[dist-bucket] rank {rank}: a 64-row slab, {per_iter:.4f} s/iteration, costs "
        f"{slabs['costs']}, collectives {slabs['collectives']}; at cg_iter "
        f"{DIST_BUCKET_CG_ITER} costs {slabs['held_costs']} ({card})")
    return lamino, gaussian, slabs


def _gloo_cuda_all_gather(mesh, device, rank: int) -> dict:
    """Whether gloo's all_gather takes CUDA tensors: one call on a CUDA
    buffer of GLOO_CHECK_BYTES, each rank's filled with its rank + 1, its
    result checked; where it is taken and right, the mean ms of
    GLOO_CHECK_REPEATS such calls. Beside it, the mean ms of as many of the
    mesh's exchanges of the same buffer, which stage it through page-locked
    host memory (``parallel._mesh._with_remote``)."""
    import torch.distributed as dist

    from tike_tpu_torch.parallel import _mesh

    mine = torch.full((GLOO_CHECK_BYTES,), rank + 1, dtype=torch.uint8, device=device)

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(GLOO_CHECK_REPEATS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) / GLOO_CHECK_REPEATS * 1e3

    staged_ms = timed(lambda: _mesh._with_remote([mine], mesh.flat))
    everyone = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    try:
        dist.all_gather(everyone, mine)
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as error:
        return dict(accepted=False, error=str(error).splitlines()[0], staged_ms=staged_ms)
    right = all(bool((t == r + 1).all()) for r, t in enumerate(everyone))
    direct_ms = timed(lambda: dist.all_gather(everyone, mine)) if right else None
    return dict(accepted=True, right=right, direct_ms=direct_ms, staged_ms=staged_ms)


def dist_worker(argv) -> None:
    """One of phase 23's processes: ``chip_smoke.py --worker RANK STORE
    OUT``. Joins the gloo group through the file STORE, runs 23a-23d on
    its one shard of ``cuda:0`` (23d's Bucket projections from
    ``OUT.bucket.npy``) and writes its records to ``OUT.RANK.json``
    and its arrays to ``OUT.RANK.npz``; the kernels were built by the
    parent. It never prints the script's result lines."""
    import datetime

    rank, store, out = int(argv[0]), argv[1], argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // DIST_WORLD))
    distributed.initialize(
        init_method=f"file://{store}", num_processes=DIST_WORLD, process_id=rank,
        backend="gloo", timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S // 2),
    )
    device = torch.device(DIST_DEVICE)
    card = nvidia_smi_line()
    mesh = distributed.global_mesh(local_devices=[device])
    records, arrays = {"gloo_cuda": _gloo_cuda_all_gather(mesh, device, rank)}, {}
    for key, value in _dist_slice(mesh, device, False).items():
        arrays[f"slice/{key}"] = value
    scan, psi, probe = make_inputs(N_PATTERNS)
    data = tp.simulate(DET, probe, scan, psi, device=device)
    rows = distributed.stripe_for_process(scan)
    local = data[rows]
    log(f"[dist-main] rank {rank}: {local.shape[0]} patterns of its stripe on the host "
        f"({local.nbytes / 1e6:.0f} MB)")
    records["main"], main_arrays = _dist_context(
        f"dist-main-{rank}",
        tp.Reconstruction(local, path_parameters(scan, psi, probe), device=device,
                          random_seed=0, mesh=mesh),
        card,
    )
    arrays.update({f"main/{k}": v for k, v in main_arrays.items()})
    own = parallel_striped.striped_local_indices(scan, psi.shape[-2:], probe.shape[-1], mesh)
    local = data[own]
    del data
    records["striped"], striped_arrays = _dist_context(
        f"dist-striped-{rank}",
        tp.Reconstruction(local, path_parameters(scan, psi, probe), device=device, mesh=mesh,
                          object_sharding="striped"),
        card,
    )
    records["striped"]["patterns"] = int(local.shape[0])
    arrays.update({f"striped/{k}": v for k, v in striped_arrays.items()})
    del local
    records["lamino"], records["lamino_gaussian"], records["bucket"] = _dist_lamino(
        mesh, device, card, rank, np.load(f"{out}.bucket.npy"))
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(records, f)
    np.savez(f"{out}.{rank}.npz", **arrays)
    torch.distributed.destroy_process_group()


def _launch_dist_workers(card: str, bucket_data: np.ndarray) -> tuple:
    """Start phase 23's two worker processes together, handing them 23d's
    Bucket projections ``bucket_data`` in a file, and wait for both (each
    at most DIST_TIMEOUT_S); a worker that fails or hangs fails the phase.
    Returns each rank's (records, arrays)."""
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    store, out = os.path.join(workdir, "store"), os.path.join(workdir, "out")
    np.save(f"{out}.bucket.npy", bucket_data)
    here = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(rank),
                          store, out], cwd=here, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for rank in range(DIST_WORLD)
    ]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  [rank {rank}] {line}")
        if proc.returncode:
            raise RuntimeError(f"phase 23: worker {rank} exited with {proc.returncode}")
    log(f"[dist] the two workers ran 23a-23d in {time.perf_counter() - start:.1f} s, "
        f"start-up included ({card})")
    out_ranks = []
    for rank in range(DIST_WORLD):
        with open(f"{out}.{rank}.json") as f:
            records = json.load(f)
        out_ranks.append((records, dict(np.load(f"{out}.{rank}.npz"))))
    shutil.rmtree(workdir)
    return out_ranks


def _same_or_gap(tag, a: dict, b: dict, keys) -> dict:
    """Each key's largest |difference| over the largest |value| of ``b``
    (0.0 where equal bit for bit)."""
    gaps = {}
    for key in keys:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.shape != y.shape:
            raise AssertionError(f"{tag}: {key} has shape {x.shape}, not {y.shape}")
        gaps[key] = 0.0 if np.array_equal(x, y) else float(
            np.max(np.abs(x - y)) / max(np.max(np.abs(y)), 1e-30)
        )
    return gaps


def phase_distributed(device, scan, psi, probe, card: str, mesh_main: dict, striped: dict,
                      lamino_mesh: dict, bucket_mesh: dict) -> tuple:
    """23: two processes, each with one shard on ``cuda:0`` in a gloo group
    (``parallel.distributed``). The parent first runs the one-process
    references of the same global programs on ``[cuda:0, cuda:0]``, then
    frees the card's cache and starts both workers; 23a-23d as the module's
    docstring says. Returns the workers' kernel counts, per rank, and their
    Gaussian cgrad's costs, which 25d holds."""
    started = time.perf_counter()
    two = _on_card_mesh(device, 2)
    slice_ref = _dist_slice(two, device, True)
    data = tp.simulate(DET, probe, scan, psi, device=device)
    ref, ref_arrays = _dist_context(
        "dist-force-stripes",
        tp.Reconstruction(data, path_parameters(scan, psi, probe), device=device,
                          random_seed=0, mesh=two, _force_stripes=2),
        card,
    )
    del data
    log(f"[dist] one process, the multi-process layout of 2 (_force_stripes=2) on 2 shards of "
        f"{device}: {ref['epoch_s']:.4f} s/epoch, set-up {ref['setup_s']:.2f} s "
        f"{ref['setup_parts']}, peak {ref['peak'] / 2**30:.3f} GiB ({card})")
    bucket_ref = _dist_bucket_reference(two, device, card)
    torch.cuda.empty_cache()
    ranks = _launch_dist_workers(card, bucket_ref.pop("data"))
    (r0, a0), (r1, a1) = ranks
    log(f"[dist] gloo's all_gather of CUDA tensors ({GLOO_CHECK_BYTES} bytes a rank, mean of "
        f"{GLOO_CHECK_REPEATS} calls; staged_ms is the mesh's exchange through page-locked "
        f"host memory): rank 0 {r0['gloo_cuda']}, rank 1 {r1['gloo_cuda']} ({card})")
    # 23a: phase 5's slice, each rank against the other and the one-process run.
    keys = ("psi", "probe", "scan", "costs")
    slices = [{k: a[f"slice/{k}"] for k in keys} for a in (a0, a1)]
    between = _same_or_gap("23a", slices[1], slices[0], keys)
    against = _same_or_gap("23a", slices[0], slice_ref, keys)
    if any(between.values()) or not max(against.values()) <= 1e-6:
        raise AssertionError(f"23a: ranks differ by {between}; against one process {against}")
    log(f"[dist-slice] 23a: phase 5's slice in 2 processes on {device}: the ranks equal bit "
        f"for bit; against one process's _force_stripes=2 on 2 shards, max|diff| / "
        f"max|value| {against} (0.0 is bit for bit; held at 1e-6) ({card})")
    # 23b: the main path at full width.
    mains = [{k: a[f"main/{k}"] for k in ("psi", "probe", "scan")} for a in (a0, a1)]
    between = _same_or_gap("23b", mains[1], mains[0], ("psi", "probe", "scan"))
    if any(between.values()) or r0["main"]["costs"] != r1["main"]["costs"]:
        raise AssertionError(f"23b: the ranks differ: {between}")
    against = _same_or_gap("23b", mains[0], ref_arrays, ("psi", "probe", "scan"))
    if not against["psi"] <= DIST_PSI_TOL:
        raise AssertionError(f"23b: psi differs from one process's by {against['psi']:.3e}")
    for rank, r in enumerate((r0, r1)):
        m = r["main"]
        log(f"[dist-main] 23b rank {rank}: {m['epoch_s']:.4f} s/epoch against 21b's one-process "
            f"two shards {mesh_main['epoch_s']:.4f} and the one-process layout's "
            f"{ref['epoch_s']:.4f}; set-up {m['setup_s']:.2f} s {m['setup_parts']}; peak "
            f"{m['peak'] / 2**30:.3f} GiB; collectives an epoch "
            f"{m['collective_calls_epoch']:.0f} calls, {m['collective_ms_epoch']:.1f} ms, "
            f"{m['collective_bytes_epoch'] / 1e6:.1f} MB; patch launches "
            f"{ {k: m['launches'][k] for k in patch.LAUNCHES} } ({card})")
    log(f"[dist-main] 23b: the ranks equal bit for bit; against one process's "
        f"_force_stripes=2 run max|diff| / max|value| {against} (psi held at "
        f"{DIST_PSI_TOL:g}); final cost {r0['main']['costs'][-1]:.6e} against "
        f"{ref['costs'][-1]:.6e} ({card})")
    # 23c: the striped object, one stripe a process, against 22b's stripes.
    strip = [{k: a[f"striped/{k}"] for k in ("psi", "probe", "scan")} for a in (a0, a1)]
    between = _same_or_gap("23c", strip[1], strip[0], ("psi", "probe", "scan"))
    reference = {k: getattr(striped["result"], k) for k in ("psi", "probe", "scan")}
    against = _same_or_gap("23c", strip[0], reference, ("psi", "probe", "scan"))
    if any(between.values()) or not against["psi"] <= DIST_PSI_TOL:
        raise AssertionError(f"23c: ranks {between}; against 22b {against}")
    for rank, r in enumerate((r0, r1)):
        s = r["striped"]
        log(f"[dist-striped] 23c rank {rank}: {s['patterns']} patterns of its stripe; "
            f"{s['epoch_s']:.4f} s/epoch against 22b's {striped['epoch_s']:.4f}; set-up "
            f"{s['setup_s']:.2f} s {s['setup_parts']}; peak {s['peak'] / 2**30:.3f} GiB; "
            f"collectives an epoch {s['collective_calls_epoch']:.0f} calls, "
            f"{s['collective_ms_epoch']:.1f} ms, {s['collective_bytes_epoch'] / 1e6:.1f} MB "
            f"({card})")
    log(f"[dist-striped] 23c: the ranks equal bit for bit; against 22b's two stripes in one "
        f"process max|diff| / max|value| {against} ({card})")
    # 23d: laminography. cgrad's costs are held to 21c's; the Bucket
    # solver's, at DIST_BUCKET_CG_ITER, to the parent's run on the same
    # projections (_dist_bucket_reference), and its timed run's only beside
    # 21d's.
    for kind, ref_run in (("lamino", lamino_mesh), ("bucket", bucket_mesh)):
        held = "held_costs" if kind == "bucket" else "costs"
        ref_costs = bucket_ref["costs"] if kind == "bucket" else ref_run["costs"]
        c0, c1, h0, h1, cr = (np.asarray(x) for x in (
            r0[kind]["costs"], r1[kind]["costs"], r0[kind][held], r1[kind][held], ref_costs))
        gap = float(np.max(np.abs(h0 - cr) / np.abs(cr)))
        if (not np.array_equal(c0, c1) or not np.array_equal(h0, h1)
                or not gap <= MESH_LAMINO_RTOL or not c0[-1] < c0[0]):
            raise AssertionError(f"23d {kind}: costs {c0} / {c1}; held {h0} / {h1} against {cr}")
        if kind == "bucket" and (r0[kind]["outside"] or r1[kind]["outside"]):
            raise AssertionError("23d bucket: points fell outside their tile's window")
        timed_gap = float(np.max(np.abs(c0 - np.asarray(ref_run["costs"]))
                                 / np.abs(np.asarray(ref_run["costs"]))))
        against = ("21's" if kind == "lamino" else
                   f"one process's at cg_iter {DIST_BUCKET_CG_ITER} on the same projections")
        log(f"[dist-{kind}] 23d: {r0[kind]['per_iter']:.4f} / {r1[kind]['per_iter']:.4f} "
            f"s/iteration (rank 0 / 1) against 21's one-process two shards "
            f"{ref_run['per_iter']:.4f}; costs equal across the ranks, max relative gap to "
            f"{against} {gap:.3e} (rtol {MESH_LAMINO_RTOL:g}; 0 is bit for bit); the timed "
            f"run's to 21's {timed_gap:.3e} ({card})")
    g0, g1 = (np.asarray(r["lamino_gaussian"]["costs"]) for r in (r0, r1))
    if not (np.array_equal(g0, g1) and np.all(np.isfinite(g0)) and g0[-1] < g0[0]):
        raise AssertionError(f"23d gaussian: costs {g0} / {g1}")
    log(f"[dist-gaussian] 23d: cgrad with the Gaussian window (cg_iter 1, "
        f"{GAUSSIAN_MESH_ITER} outer iterations), costs {g0.tolist()} equal across the ranks; "
        f"held against one process in 25d ({card})")
    log(f"[dist] phase 23 took {time.perf_counter() - started:.1f} s ({card})")
    # Each run's counts of every kernel, as its rank read them.
    counts = {}
    for rank, r in enumerate((r0, r1)):
        for run, path_kernels in (("main", patch.LAUNCHES), ("striped", patch.LAUNCHES),
                                  ("lamino", USFFT_KERNELS), ("bucket", BUCKET_KERNELS),
                                  ("lamino_gaussian", GAUSSIAN_KERNELS)):
            launches = r[run]["launches"]
            if not all(launches[k] > 0 for k in path_kernels):
                raise AssertionError(f"23 {run} rank {rank}: a kernel of the path was not "
                                     f"launched: {launches}")
            counts.setdefault(f"launches_distributed_{run}", []).append(launches)
    return counts, g0.tolist()


def _example(name: str, run, card: str) -> tuple:
    """``run()`` with every kernel count set to 0 just before it and read
    just after; fails if a kernel that EXAMPLE_KERNELS gives ``name`` read
    0. Returns (its result, the counts, its seconds)."""
    torch.cuda.synchronize()
    _reset_launches()
    start = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = _read_launches(name)
    missing = [k for k in EXAMPLE_KERNELS[name] if not launches[k]]
    if missing:
        raise AssertionError(f"examples: {name} launched no {missing}: {launches}")
    log(f"[examples] {name}: {seconds:.2f} s on the card ({card}); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return out, launches, seconds


def _examples() -> dict:
    return {name: cases_examples.load("examples", name) for name in cases_examples.EXAMPLES}


def _close_rel(tag: str, got, ref, tol: float) -> float:
    err = _max_rel(np.asarray(got), np.asarray(ref))
    if not err <= tol:
        raise AssertionError(f"examples, small: {tag} differs by {err:.3e} (tol {tol:g})")
    return err


@contextlib.contextmanager
def _seeded_admm():
    """Each angle's rPIE drawn from seed 0 (the ADMM leaves it unseeded, as
    tike_tpu's does) and each volume fit at cg_iter 1, where no line-search
    trial is a tie (ROADMAP.md section 3): the protocol of
    tests/test_torch_examples_admm.py, so that the card and the CPU run one
    computation."""
    recon, fit = tp.Reconstruction, tadmm.lamino_reconstruct
    tp.Reconstruction = functools.partial(recon, random_seed=0)
    tadmm.lamino_reconstruct = lambda **kw: fit(**kw, cg_iter=1)
    try:
        yield
    finally:
        tp.Reconstruction, tadmm.lamino_reconstruct = recon, fit


def phase_examples_small(device) -> None:
    """24a, the small sizes: each example on the card and on the CPU path
    from the same inputs (tests/_torch_examples_cases.py's sizes), held
    together as phases 5, 10 and 13 hold their slices."""
    ex, c = _examples(), cases_examples
    got, ref = (ex["scan"].main(figure=None, device=dev) for dev in (device, "cpu"))
    for key in ("waves", "trajectories"):
        for name in ref[key]:
            np.testing.assert_array_equal(np.asarray(got[key][name]), np.asarray(ref[key][name]))
    got, ref = (ex["align"].main(**c.SMALL_ALIGN, device=dev) for dev in (device, "cpu"))
    sim = _close_rel("align simulate", got["unaligned"], ref["unaligned"], LAMINO_SIM_TOL)
    np.testing.assert_allclose(got["shift"], ref["shift"], rtol=0, atol=1e-6)
    log(f"[examples] align {c.SMALL_ALIGN} on {device} vs cpu: simulate {sim:.2e}, shifts "
        f"equal within 1e-6 px")

    got, ref = (ex["lamino"].main(**c.SMALL_LAMINO, device=dev) for dev in (device, "cpu"))
    errs = {
        "data": _close_rel("lamino data", got["data"], ref["data"], LAMINO_SIM_TOL),
        "obj": _close_rel("lamino cgrad volume", got["obj"], ref["obj"], LAMINO_SLICE_TOL),
        "bucket_data": _close_rel("bucket data", got["bucket_data"], ref["bucket_data"],
                                  LAMINO_SIM_TOL),
        "bucket_obj": _close_rel("bucket volume", got["bucket_obj"], ref["bucket_obj"],
                                 LAMINO_SLICE_TOL),
    }
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=LAMINO_SLICE_TOL)
    np.testing.assert_allclose(got["bucket_cost"], ref["bucket_cost"], rtol=LAMINO_SLICE_TOL)
    log(f"[examples] lamino {c.SMALL_LAMINO} on {device} vs cpu: costs {got['cost'].tolist()} "
        f"vs {ref['cost'].tolist()}, bucket {got['bucket_cost'].tolist()} vs "
        f"{ref['bucket_cost'].tolist()}; max|err| / max|value| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }")

    small = c.SMALL_PTYCHO
    data, scan, probe, psi = ex["ptycho"].load_dataset(device="cpu")
    n = small["patterns"]
    data, scan = data[:n], scan[:n]
    runs = {}
    for dev in (device, "cpu"):
        rpie = ex["ptycho"].rpie_stage(data, scan, probe, psi, small["rpie_iter"], device=dev)
        rpie_out = {k: np.array(getattr(rpie, k)) for k in ("psi", "probe")}
        rpie_out["costs"] = np.asarray(rpie.algorithm_options.costs)
        lsqml = ex["ptycho"].lsqml_stage(data, rpie, small["lsqml_iter"], device=dev)
        runs[str(dev)] = rpie_out, convert.parameters_to_numpy(lsqml)
    (rpie, lsqml), (rpie_ref, lsqml_ref) = runs[str(device)], runs["cpu"]
    for costs in (rpie["costs"], lsqml["costs"]):
        costs = np.ravel(costs)
        if not (np.all(np.isfinite(costs)) and costs[-1] < costs[0]):
            raise AssertionError(f"examples, small: ptycho costs {costs}")
    np.testing.assert_allclose(rpie["costs"], rpie_ref["costs"], rtol=SLICE_TOL)
    np.testing.assert_allclose(lsqml["costs"], lsqml_ref["costs"], rtol=SLICE_TOL)
    errs = {f"rpie {k}": _close_rel(f"ptycho rpie {k}", rpie[k], rpie_ref[k], SLICE_TOL)
            for k in ("psi", "probe")}
    errs.update({
        f"lsqml {k}": _close_rel(f"ptycho lsqml {k}", lsqml[k], lsqml_ref[k], SLICE_TOL)
        for k in ("psi", "probe", "eigen_probe", "eigen_weights")
    })
    np.testing.assert_allclose(lsqml["scan"], lsqml_ref["scan"], rtol=0, atol=SLICE_SCAN_TOL)
    log(f"[examples] ptycho {small} on {device} vs cpu: rPIE costs "
        f"{np.ravel(rpie['costs']).tolist()}, LSQML {np.ravel(lsqml['costs']).tolist()}; "
        f"max|err| / max|value| { {k: f'{v:.2e}' for k, v in errs.items()} }; scan "
        f"{float(np.max(np.abs(lsqml['scan'] - lsqml_ref['scan']))):.2e} px")

    with _seeded_admm():
        got, ref = (
            convert.admm_result_to_numpy(ex["admm"].run(**c.SMALL_ADMM, device=dev)["result"])
            for dev in (device, "cpu")
        )
    if not (np.all(np.isfinite(got["costs"])) and got["costs"][-1] < got["costs"][0]):
        raise AssertionError(f"examples, small: admm costs {got['costs']}")
    np.testing.assert_allclose(got["costs"], ref["costs"], rtol=SLICE_TOL)
    errs = {k: _close_rel(f"admm {k}", got[k], ref[k], SLICE_TOL) for k in ("psi", "obj")}
    log(f"[examples] admm {c.SMALL_ADMM} (seeded rPIE, fits at cg_iter 1) on {device} vs cpu: "
        f"costs {got['costs'].tolist()} vs {ref['costs'].tolist()}; max|err| / max|value| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }")


def phase_examples(device, card: str) -> dict:
    """24a-c at the examples' and scripts' own sizes; returns each run's
    kernel counts by name."""
    ex, launches = _examples(), {}
    out, launches["scan"], _ = _example(
        "scan", lambda: ex["scan"].main(figure=None, device=device), card)
    series = list(out["waves"].values()) + [a for p in out["trajectories"].values() for a in p]
    if len(series) != 18 or not all(np.all(np.isfinite(x)) for x in series):
        raise AssertionError("examples: scan series not finite")
    out, launches["align"], _ = _example("align", lambda: ex["align"].main(device=device), card)
    if not out["max_shift_error"] <= EXAMPLE_SHIFT_TOL:
        raise AssertionError(f"examples: align shift error {out['max_shift_error']:.3f} px")
    log(f"[examples] align: max shift error {out['max_shift_error']:.4f} px (tol "
        f"{EXAMPLE_SHIFT_TOL:g}), residual after inverting {out['residual']:.4f}")
    out, launches["lamino"], _ = _example("lamino", lambda: ex["lamino"].main(device=device),
                                          card)
    for key in ("cost", "bucket_cost"):
        if not (np.all(np.isfinite(out[key])) and out[key][-1] < out[key][0]):
            raise AssertionError(f"examples: lamino {key} {out[key]}")
    if not out["error"] < 0.5:
        raise AssertionError(f"examples: lamino relative error {out['error']:.3f}")
    log(f"[examples] lamino: relative error {out['error']:.4f}; cgrad costs "
        f"{out['cost'].tolist()}; bucket {out['bucket_cost'].tolist()}")
    out, launches["ptycho"], _ = _example(
        "ptycho", lambda: ex["ptycho"].main(figure=None, device=device), card)
    for key in ("rpie_costs", "lsqml_costs"):
        if not (np.all(np.isfinite(out[key])) and out[key][-1] < out[key][0]):
            raise AssertionError(f"examples: ptycho {key} {out[key]}")
    log(f"[examples] ptycho: rPIE {len(out['rpie_costs'])} epochs {out['rpie_costs'][0]:.4e} -> "
        f"{out['rpie_costs'][-1]:.4e}; LSQML {len(out['lsqml_costs'])} epochs "
        f"{out['lsqml_costs'][0]:.4e} -> {out['lsqml_costs'][-1]:.4e}")
    out, launches["admm"], _ = _example("admm", lambda: ex["admm"].main(device=device), card)
    log(f"[examples] admm: corr {out['corr']:.4f} (> 0.5), costs {out['costs'].tolist()}")

    quality = cases_examples.load("scripts", "admm_quality")
    records, launches["admm_quality"], _ = _example("admm_quality", lambda: {
        phantom: quality.run(iters=iters, rho=rho, phantom=phantom, device=device)
        for phantom, (iters, rho, _) in QUALITY.items()
    }, card)
    for phantom, record in records.items():
        pinned = QUALITY[phantom][2]
        log(f"[examples] admm_quality {phantom}: admm_corr {record['admm_corr']} (pinned "
            f">= {pinned}), ceiling_corr {record['ceiling_corr']}, twostep_corr "
            f"{record['twostep_corr']}, admm {record['admm_sec']} s ({card})")
        if not record["admm_corr"] >= pinned:
            raise AssertionError(f"examples: admm_quality {phantom} {record['admm_corr']} < "
                                 f"{pinned}")

    demo = cases_examples.load("scripts", "striped_demo")
    meshes = {"make_mesh()": parallel.make_mesh(), "[cuda:0, cuda:0]": _on_card_mesh(device, 2)}
    records, launches["striped_demo"], _ = _example("striped_demo", lambda: {
        name: demo.run(**STRIPED_DEMO, mesh=mesh, device=device)[0] for name, mesh in meshes.items()
    }, card)
    for name, record in records.items():
        log(f"[examples] striped_demo on {name}: {record['devices']} stripes, window "
            f"{record['window_rows']} rows ({record['window_mb']} of {record['psi_mb']} MB), "
            f"{record['s_per_epoch']} s/epoch after {record['setup_s']} s of set-up, costs "
            f"{record['cost_first_last']}, interior corr "
            f"{record['interior_corr_vs_truth']} ({card})")

    longaxis = cases_examples.load("scripts", "longaxis_demo")
    (record, _), launches["longaxis_demo"], _ = _example(
        "longaxis_demo", lambda: longaxis.run(LONGAXIS_PATTERNS, device=device), card)
    if not np.all(np.isfinite(record["costs"])):
        raise AssertionError(f"examples: longaxis costs {record['costs']}")
    log(f"[examples] longaxis_demo at {LONGAXIS_PATTERNS:,} patterns (phase 15 runs 1,000,000): "
        f"{record['patterns_per_s']} patterns/s, {record['epoch_s']} s/epoch, host data "
        f"{record['host_data_gb']} GB, peak RSS {record['peak_rss_gb']} GB, peak device "
        f"{record['peak_device_gb']} GB ({card})")
    return launches


def phase_gaussian_parity(device, card: str) -> dict:
    """25a: the Gaussian window's gather and scatter on laminography's
    points at bench_all.py's 128^3 / 64 angles, at upsample 1 (m = 2) and 2
    (m = 4): each against its plain version and its first form (the KB
    kernels on the same plan) at ``KB_TOL`` of the largest value,
    adjointness, three launches of each bitwise equal (two on one plan, one
    building its own); times in CUDA graphs in turns with the first form and
    the KB kernel at the same upsample, the plain version's, the plan's
    build and bytes, beside the bound pipe by pipe."""
    gen = torch.Generator(device=device).manual_seed(25)
    x = cases_usfft.lamino_rows(cases_usfft.LAMINO_N, cases_usfft.LAMINO_NTHETA, device)
    x = x.reshape(-1, 3)
    out = {name: {"library_ms": None, "card": card} for name in GAUSSIAN_KERNELS}
    for upsample in GAUSSIAN_UPSAMPLES:
        n, m, mu = cases_usfft.gaussian_window_for(cases_usfft.LAMINO_N, cases_usfft.LAMINO_EPS,
                                                   upsample)
        _, m_kb, beta = cases_usfft.window_for(cases_usfft.LAMINO_N, cases_usfft.LAMINO_EPS,
                                               upsample)
        case = f"128^3 / 64 angles, upsample {upsample}"
        grid = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=gen)
        f = torch.randn(x.shape[0], dtype=torch.complex64, device=device, generator=gen)
        errs = cases_usfft.check_kernels(grid, x, f, n, m, mu, case, "gaussian")
        # m >= 2: the gather takes the scatter's plan, in bin order, as
        # LaminoPlan hands it.
        plan, plan_ms = _timed_plan(x, n, m, mu, window="gaussian")
        kb_gather_plan = usfft.geometry_plan(x, n, m_kb, beta, usfft.gather_tile(m_kb))
        kb_plan = usfft.geometry_plan(x, n, m_kb, beta)
        first_errs = {
            "usfft_gather_gaussian": cases_usfft.max_rel(
                usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan),
                cases_usfft.first_form_gather(grid, plan)),
            "usfft_scatter_gaussian": cases_usfft.max_rel(
                usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan),
                cases_usfft.first_form_scatter(f, plan)),
        }
        for name, err in first_errs.items():
            if not err <= cases_usfft.KB_TOL:
                raise AssertionError(f"{name} ({case}): {err:.3e} from its first form")
        log(f"[gaussian] {case}: grid {n}^3, m = {m} (KB m = {m_kb}), {x.shape[0]} points: "
            f"gather max|err| {errs['usfft_gather_gaussian_abs']:.3e} "
            f"({errs['usfft_gather_gaussian']:.2e} of max|value|), scatter "
            f"{errs['usfft_scatter_gaussian_abs']:.3e} ({errs['usfft_scatter_gaussian']:.2e}; tol "
            f"{cases_usfft.KB_TOL:g}); adjointness {errs['adjoint']:.2e} (tol "
            f"{cases_usfft.ADJOINT_TOL:g}); three gathers and three scatters (two on one plan, "
            f"one building its own) bitwise equal; against the first form "
            f"{first_errs['usfft_gather_gaussian']:.2e} / {first_errs['usfft_scatter_gaussian']:.2e}"
            f" of max|value| ({len(plan.blocks)} scatter blocks)")
        calls = {
            "usfft_gather_gaussian": (
                lambda: usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan),
                lambda: cases_usfft.first_form_gather(grid, plan),
                lambda: usfft.gather_kb_cuda(grid, x, n, m_kb, beta, kb_gather_plan),
                lambda: usfft.gather_gaussian_plain(grid, x, n, m, mu),
            ),
            "usfft_scatter_gaussian": (
                lambda: usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan),
                lambda: cases_usfft.first_form_scatter(f, plan),
                lambda: usfft.scatter_kb_cuda(f, x, n, m_kb, beta, kb_plan),
                lambda: usfft.scatter_gaussian_plain(f, x, n, m, mu),
            ),
        }
        suffix = "" if upsample == 1 else f"_upsample{upsample}"
        for name, (kernel, first, kb, plain) in calls.items():
            ms = graph_ms_in_turns({"gaussian": kernel, "first_form": first, "kb": kb})
            plain_ms = median_ms_in_turns({"plain": plain}, reps=1, rounds=1)["plain"]
            bound = cases_usfft.gaussian_roofline(name, x, n, m)
            out[name].update({
                f"max_abs_err{suffix}": errs[f"{name}_abs"],
                f"max_rel_err{suffix}": errs[name],
                f"adjoint_err{suffix}": errs["adjoint"],
                f"ms{suffix}": ms["gaussian"],
                f"first_form_ms{suffix}": ms["first_form"],
                f"first_form_err{suffix}": first_errs[name],
                f"kb_ms{suffix}": ms["kb"],
                f"plain_ms{suffix}": plain_ms,
                f"plan_ms{suffix}": plan_ms,
                f"plan_bytes{suffix}": plan.nbytes,
                f"bound_bytes{suffix}": bound["bound_bytes"],
                f"bound_bytes_ms{suffix}": bound["bound_bytes_ms"],
                f"bound_fp32_ms{suffix}": bound["bound_fp32_ms"],
                f"bound_ms{suffix}": bound["bound_ms"],
                f"bound_by{suffix}": bound["bound_by"],
                f"roofline_share{suffix}": bound["bound_ms"] / ms["gaussian"],
                f"m{suffix}": m,
                "deterministic": True,
            })
            log(f"[gaussian] {name} at {case} (m = {m}): kernel {ms['gaussian']:.4f} ms (CUDA "
                f"graph, plan built beforehand: {plan_ms:.3f} ms, {plan.nbytes} bytes), its first "
                f"form {ms['first_form']:.4f} ms ({ms['first_form'] / ms['gaussian']:.2f}x) and the "
                f"KB kernel at m = {m_kb} {ms['kb']:.4f} ms in the same turns, plain "
                f"{plain_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
                f"{bound['bound_bytes']} bytes {bound['bound_bytes_ms']:.4f} ms at "
                f"{cases_usfft.HBM_BYTES_PER_S:g} B/s"
                + (f", {bound['touched_cells']} grid values touched" if bound["touched_cells"]
                   else "")
                + f"; {bound['bound_fp32_instructions']} FP32 instructions "
                f"{bound['bound_fp32_ms']:.4f} ms at {cases_usfft.FP32_INSTRUCTIONS_PER_S:g}/s), "
                f"{100 * bound['bound_ms'] / ms['gaussian']:.1f}% of it ({card})")
        del grid, f, plan, kb_gather_plan, kb_plan, calls
    return out


def _cgrad_launches(calls, cg_iter: int, reads: int) -> dict:
    """The Gaussian kernels' launches that cgrad must make in ``calls``
    reconstructions of so many outer iterations each, from a zero volume,
    with ``reads`` line-search trials in all: per outer iteration a gradient
    (a forward and an adjoint) per CG step and one cost (a forward); the
    step-length estimate (a forward and an adjoint) in each call's first
    outer iteration and, since a zero volume's estimate falls back to 1, in
    its second; a forward per trial."""
    iterations = sum(calls)
    estimates = sum(min(2, k) for k in calls)
    return {
        "usfft_gather_gaussian": (cg_iter + 1) * iterations + estimates + reads,
        "usfft_scatter_gaussian": cg_iter * iterations + estimates,
    }


def phase_gaussian_lamino(device, card: str, problem, cgrad: dict) -> dict:
    """25b: ``reconstruct(kernel="gaussian")`` on phase 11's problem: cgrad
    at ``cg_iter=4``, one warm-up outer iteration and LAMINO_TIMED timed
    ones, every kernel count set to 0 just before and read just after,
    costs finite and falling, s/iteration beside phase 11's KB run, the
    Gaussian kernels' launches equal to ``_cgrad_launches`` and the KB
    kernels' 0; then CGLS at cg_iter 1 once, LAMINO_TIMED outer
    iterations, 2 launches of each Gaussian kernel an iteration."""
    volume, theta, data = problem
    kwargs = dict(eps=cases_usfft.LAMINO_EPS, upsample=1, kernel="gaussian", device=device)

    def run(algorithm, num_iter, cg_iter):
        start = time.perf_counter()
        result = tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, algorithm,
                                num_iter=num_iter, cg_iter=cg_iter, **kwargs)
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    def check(tag, costs, count, launches, want):
        if len(costs) != count or not np.all(np.isfinite(costs)):
            raise AssertionError(f"{tag}: costs are not {count} finite values: {costs}")
        if not (costs[-1] < costs[0] and np.all(np.diff(costs) <= 1e-6 * costs[:-1])):
            raise AssertionError(f"{tag}: costs do not decrease: {costs}")
        got = {name: launches[name] for name in usfft.LAUNCHES}
        if got != {**{name: 0 for name in USFFT_KERNELS}, **want}:
            raise AssertionError(f"{tag}: USFFT launches {got}, predicted {want} and no KB one")

    _reset_launches()
    opt.HOST_READS["line_search"] = 0
    torch.cuda.reset_peak_memory_stats()
    warm, first_s = run("cgrad", 1, LAMINO_CG_ITER)
    result, timed_s = run("cgrad", LAMINO_TIMED, LAMINO_CG_ITER)
    launches = _read_launches("gaussian-cgrad")
    reads = opt.HOST_READS["line_search"]
    peak = torch.cuda.max_memory_allocated()
    want = _cgrad_launches((1, LAMINO_TIMED), LAMINO_CG_ITER, reads)
    costs = result["cost"]
    check("gaussian-cgrad", costs, LAMINO_TIMED, launches, want)
    obj = result["obj"]
    if obj.shape != volume.shape or not np.all(np.isfinite(obj)):
        raise AssertionError("gaussian-cgrad: the volume is not finite or has the wrong shape")
    per_iter = timed_s / LAMINO_TIMED
    log(f"[gaussian-cgrad] costs {costs.tolist()} (warm-up {warm['cost'].tolist()}); "
        f"{LAMINO_TIMED} outer iterations (cg_iter {LAMINO_CG_ITER}) in {timed_s:.3f} s = "
        f"{per_iter:.4f} s/iteration against phase 11's KB {cgrad['per_iter']:.4f} "
        f"({per_iter / cgrad['per_iter']:.3f}x); first call {first_s:.3f} s, so set-up "
        f"{first_s - per_iter:.3f} s; peak {peak} bytes; launches "
        f"{ {k: launches[k] for k in usfft.LAUNCHES} } with {reads} line-search trials, as "
        f"predicted ({card})")
    _reset_launches()
    cgls, cgls_s = run("cgls", LAMINO_TIMED, 1)
    cgls_launches = _read_launches("gaussian-cgls")
    per_trip = 2 * LAMINO_TIMED
    check("gaussian-cgls", cgls["cost"], LAMINO_TIMED, cgls_launches,
          {name: per_trip for name in GAUSSIAN_KERNELS})
    log(f"[gaussian-cgls] cg_iter 1, {LAMINO_TIMED} outer iterations: costs "
        f"{cgls['cost'].tolist()}, {cgls_s / LAMINO_TIMED:.4f} s/iteration with its set-up; "
        f"launches {per_trip} of each Gaussian kernel, as predicted ({card})")
    return dict(launches=launches, launches_cgls=cgls_launches, per_iter=per_iter)


# 25d: the theta split against one device at cg_iter 1, where no line-search
# trial ties: costs relative, the volume relative to its largest value. Phase
# 23's workers run the same split across two processes.
GAUSSIAN_MESH_ITER, GAUSSIAN_MESH_COST_TOL, GAUSSIAN_MESH_OBJ_TOL = 3, 1e-5, 1e-4
GAUSSIAN_MESH_KWARGS = dict(kernel="gaussian", cg_iter=1, num_iter=GAUSSIAN_MESH_ITER)


def phase_gaussian_mesh(device, card: str, problem, dist_costs) -> dict:
    """25d: cgrad with the Gaussian window at cg_iter 1 on phase 11's
    problem, the angles split over ``[cuda:0, cuda:0]`` against one device:
    each shard's transforms launch the Gaussian kernels (counted), costs
    and volume held together; phase 23's two processes' costs
    ``dist_costs`` held against the split's."""
    volume, theta, data = problem
    kwargs = dict(eps=cases_usfft.LAMINO_EPS, upsample=1, device=device, **GAUSSIAN_MESH_KWARGS)
    single = tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, "cgrad", **kwargs)
    _reset_launches()
    start = time.perf_counter()
    split = tl.reconstruct(data, theta, cases_usfft.LAMINO_TILT, "cgrad",
                           mesh=_on_card_mesh(device, 2), **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = _read_launches("gaussian-mesh")
    for name in GAUSSIAN_KERNELS:
        if not launches[name] > 0:
            raise AssertionError(f"gaussian-mesh launched no {name} kernel: {launches}")
    gap = float(np.max(np.abs(split["cost"] - single["cost"]) / np.abs(single["cost"])))
    obj_gap = _max_rel(split["obj"], single["obj"])
    dist_gap = float(np.max(np.abs(np.asarray(dist_costs) - split["cost"])
                            / np.abs(split["cost"])))
    if not (gap <= GAUSSIAN_MESH_COST_TOL and obj_gap <= GAUSSIAN_MESH_OBJ_TOL
            and dist_gap <= GAUSSIAN_MESH_COST_TOL):
        raise AssertionError(
            f"gaussian-mesh: costs {split['cost']} against one device's {single['cost']} (gap "
            f"{gap:.3e}, tol {GAUSSIAN_MESH_COST_TOL:g}), volume gap {obj_gap:.3e} (tol "
            f"{GAUSSIAN_MESH_OBJ_TOL:g}); two processes' costs {dist_costs} (gap "
            f"{dist_gap:.3e})")
    log(f"[gaussian-mesh] cgrad (cg_iter 1, {GAUSSIAN_MESH_ITER} outer iterations) with "
        f"{theta.shape[0]} angles over 2 shards on {device}: costs {split['cost'].tolist()} "
        f"against one device's {single['cost'].tolist()} (max relative gap {gap:.3e}, tol "
        f"{GAUSSIAN_MESH_COST_TOL:g}); volume gap {obj_gap:.3e} of its largest value (tol "
        f"{GAUSSIAN_MESH_OBJ_TOL:g}); phase 23's two processes' costs against the split's: "
        f"max relative gap {dist_gap:.3e} (0 is bit for bit); {seconds:.3f} s; launches "
        f"{ {k: launches[k] for k in GAUSSIAN_KERNELS} } ({card})")
    return {name: launches[name] for name in GAUSSIAN_KERNELS}


def _window_of(window: str, n_volume: int, eps: float, upsample: float):
    """(grid n, m, beta or mu) of ``window`` for a transform."""
    if window == "kb":
        return cases_usfft.window_for(n_volume, eps, upsample)
    return cases_usfft.gaussian_window_for(n_volume, eps, upsample)


def phase_large_grid(device, card: str) -> dict:
    """26a: both windows' gather and scatter on laminography's points of a
    646^3 volume at upsample 2, a 1292^3 grid past 2^31 cells: against the
    plain versions on LARGE_SAMPLE of the points and LARGE_HIGH points in
    cells past the 2^31-th, with their repeats and adjointness
    (``check_kernels``); on all the points the times (the gather in a CUDA
    graph, the scatter, whose 17.25 GB grid a graph's pool would hold once a
    launch, by CUDA events) beside the bound pipe by pipe, the plain
    versions' once, the plan's ms and bytes, and the peak memory. Returns
    each kernel's record, suffixed ``_n1292``."""
    c = LARGE
    eps = cases_usfft.LAMINO_EPS
    x = cases_usfft.lamino_rows(c["n"], c["ntheta"], device).reshape(-1, 3)
    gen, torch_gen = np.random.default_rng(26), torch.Generator(device=device).manual_seed(26)
    step = x.shape[0] // LARGE_SAMPLE
    out = {}
    for window in ("kb", "gaussian"):
        n, m, param = _window_of(window, c["n"], eps, c["upsample"])
        gather, scatter, gather_plain, scatter_plain = cases_usfft.WINDOW_CALLS[window]
        gather_name, scatter_name = cases_usfft.COUNTS[window]
        case = f"{c['n']}^3 / {c['ntheta']} angles, upsample {c['upsample']}, {window}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grid = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=torch_gen)
        f = torch.randn(x.shape[0], dtype=torch.complex64, device=device, generator=torch_gen)
        sample = torch.cat([x[::step][:LARGE_SAMPLE], cases_usfft.high_cell_points(
            gen, LARGE_HIGH, n, usfft._SHIFT[window], device)])
        errs = cases_usfft.check_kernels(grid, sample, f[:sample.shape[0]].contiguous(), n, m,
                                         param, case, window)
        plan, plan_ms = _timed_plan(x, n, m, param, window=window)
        ms = {gather_name: graph_ms_per_call(lambda: gather(grid, x, n, m, param, plan)),
              scatter_name: _events_ms(lambda: scatter(f, x, n, m, param, plan), LARGE_REPEATS)}
        plain_ms = {gather_name: cases_usfft._timed(gather_plain, grid, x, n, m, param)[1],
                    scatter_name: cases_usfft._timed(scatter_plain, f, x, n, m, param)[1]}
        peak = torch.cuda.max_memory_allocated()
        log(f"[large] {case}: grid {n}^3 ({n**3} cells, {n**3 * 8} bytes), m = {m}, "
            f"{x.shape[0]} points; on {sample.shape[0]} of them ({LARGE_HIGH} in cells past the "
            f"2^31-th) gather max|err| {errs[f'{gather_name}_abs']:.3e} ({errs[gather_name]:.2e} "
            f"of max|value|), scatter {errs[f'{scatter_name}_abs']:.3e} "
            f"({errs[scatter_name]:.2e}; tol {cases_usfft.KB_TOL:g}), adjointness "
            f"{errs['adjoint']:.2e}, three launches of each bitwise equal; plan "
            f"{plan_ms:.2f} ms, {plan.nbytes} bytes; peak {peak} bytes ({card})")
        for name in (gather_name, scatter_name):
            bound = cases_usfft.gaussian_roofline(name, x, n, m, window)
            out[name] = {
                "max_abs_err_n1292": errs[f"{name}_abs"], "max_rel_err_n1292": errs[name],
                "adjoint_err_n1292": errs["adjoint"], "ms_n1292": ms[name],
                "plain_ms_n1292": plain_ms[name], "plan_ms_n1292": plan_ms,
                "plan_bytes_n1292": plan.nbytes, "bound_ms_n1292": bound["bound_ms"],
                "bound_by_n1292": bound["bound_by"],
                "bound_bytes_ms_n1292": bound["bound_bytes_ms"],
                "bound_fp32_ms_n1292": bound["bound_fp32_ms"],
                "roofline_share_n1292": bound["bound_ms"] / ms[name],
                "peak_bytes_n1292": peak, "m_n1292": m, "npoints_n1292": x.shape[0],
            }
            log(f"[large] {name} at {case}: {ms[name]:.4f} ms ("
                + ("CUDA graph" if name == gather_name else f"CUDA events, {LARGE_REPEATS} launches")
                + f"), plain {plain_ms[name]:.1f} ms once; bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}: {bound['bound_bytes']} bytes {bound['bound_bytes_ms']:.4f} "
                f"ms at {cases_usfft.HBM_BYTES_PER_S:g} B/s"
                + (f", {bound['touched_cells']} grid values touched" if bound["touched_cells"]
                   else "")
                + f"; {bound['bound_fp32_instructions']} FP32 instructions "
                f"{bound['bound_fp32_ms']:.4f} ms at {cases_usfft.FP32_INSTRUCTIONS_PER_S:g}/s), "
                f"{100 * bound['bound_ms'] / ms[name]:.1f}% of it ({card})")
        del grid, f, plan, sample
    return out


def phase_wide_window(device, card: str) -> dict:
    """26b: the Gaussian gather and scatter at m = 17, 18 and 22 (2m above
    a warp's lanes: the gather's wide form) on phase 25a's points, against
    the plain versions on WIDE_SAMPLE of them (three launches of each
    bitwise equal, adjointness), times on all of them by CUDA events beside
    the first form's gather (a thread a point), the plain versions' on the
    sample (the gather's also on all the points at m = 17), the plan's and
    the bound. Returns each kernel's record suffixed ``_m<m>``, and
    ``WIDE_GATHER``'s at m = 17."""
    x = cases_usfft.lamino_rows(cases_usfft.LAMINO_N, cases_usfft.LAMINO_NTHETA, device)
    x = x.reshape(-1, 3)
    step = x.shape[0] // WIDE_SAMPLE
    sample = x[::step][:WIDE_SAMPLE].contiguous()
    torch_gen = torch.Generator(device=device).manual_seed(27)
    out = {name: {} for name in (*GAUSSIAN_KERNELS, WIDE_GATHER)}
    gather_name, scatter_name = GAUSSIAN_KERNELS
    for eps, upsample in WIDE_CASES:
        n, m, mu = cases_usfft.gaussian_window_for(cases_usfft.LAMINO_N, eps, upsample)
        case = f"128^3 / 64 angles, eps {eps:g}, upsample {upsample}"
        grid = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=torch_gen)
        f = torch.randn(x.shape[0], dtype=torch.complex64, device=device, generator=torch_gen)
        errs = cases_usfft.check_kernels(grid, sample, f[::step][:WIDE_SAMPLE].contiguous(), n, m,
                                         mu, case, "gaussian")
        plan, plan_ms = _timed_plan(x, n, m, mu, window="gaussian")
        ms = {gather_name: _events_ms(lambda: usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan),
                                      WIDE_REPEATS),
              scatter_name: _events_ms(lambda: usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan),
                                       WIDE_REPEATS)}
        first_form_ms = _events_ms(lambda: cases_usfft.first_form_gather(grid, plan), 2)
        if (eps, upsample) == WIDE_CASES[0]:
            plain_all_ms = cases_usfft._timed(usfft.gather_gaussian_plain, grid, x, n, m, mu)[1]
            log(f"[wide] {gather_name} at {case}: the plain version on all {x.shape[0]} points "
                f"{plain_all_ms:.1f} ms, once ({card})")
        for name in GAUSSIAN_KERNELS:
            bound = cases_usfft.gaussian_roofline(name, x, n, m)
            record = {
                f"max_abs_err_m{m}": errs[f"{name}_abs"], f"max_rel_err_m{m}": errs[name],
                f"adjoint_err_m{m}": errs["adjoint"], f"ms_m{m}": ms[name],
                f"plain_ms_sample_m{m}": errs[f"{name}_plain_ms"], f"plan_ms_m{m}": plan_ms,
                f"plan_bytes_m{m}": plan.nbytes, f"bound_ms_m{m}": bound["bound_ms"],
                f"bound_by_m{m}": bound["bound_by"],
                f"roofline_share_m{m}": bound["bound_ms"] / ms[name], f"grid_m{m}": n,
            }
            if name == gather_name:
                record[f"first_form_ms_m{m}"] = first_form_ms
            out[name].update(record)
            if name == gather_name and (eps, upsample) == WIDE_CASES[0]:
                out[WIDE_GATHER].update({
                    "max_abs_err": errs[f"{name}_abs"], "ms": ms[name], "plain_ms": plain_all_ms,
                    "first_form_ms": first_form_ms, "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"], "m": m, "grid": n,
                })
            log(f"[wide] {name} at {case} (m = {m}, grid {n}^3, {x.shape[0]} points): "
                f"{ms[name]:.4f} ms (CUDA events, {WIDE_REPEATS} launches)"
                + (f", the first form (a thread a point) {first_form_ms:.4f} ms"
                   if name == gather_name else "")
                + f"; on {WIDE_SAMPLE} of the points max|err| {errs[f'{name}_abs']:.3e} "
                f"({errs[name]:.2e} of max|value|, tol {cases_usfft.KB_TOL:g}), plain "
                f"{errs[f'{name}_plain_ms']:.1f} ms there; three launches bitwise equal there, "
                f"adjointness {errs['adjoint']:.2e}; "
                f"plan {plan_ms:.2f} ms, {plan.nbytes} bytes; bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}), {100 * bound['bound_ms'] / ms[name]:.1f}% of it ({card})")
        del grid, f, plan
    return out


def _stage(stages: list, tag: str) -> None:
    """Logs and records the memory allocated now and at the most since the
    last stage."""
    torch.cuda.synchronize()
    now, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    stages.append((tag, now, peak))
    log(f"[large-lamino] stage {tag}: {now} bytes allocated, peak {peak} bytes since the last "
        f"stage")
    torch.cuda.reset_peak_memory_stats()


def phase_large_lamino(device, card: str) -> dict:
    """26c: ``reconstruct`` at 646^3, 64 angles, upsample 2, cgrad at
    cg_iter LARGE_CG_ITER with each window, every kernel count set to 0
    just before and read just after: first its stages alone, with the
    memory each holds (the plans, a forward, an adjoint), then one warm-up
    outer iteration and LARGE_TIMED timed ones (costs finite and falling,
    set-up s, s/iteration, peak memory). Where the card's memory does not
    hold it, the stages logged until then say where the memory went, and
    the run is logged as not fitting. Then a slice at m = 18 with the
    Gaussian window, card against CPU (``WIDE_SLICE``), its wide gather's
    launches counted. Returns each window's launches and the slice's."""
    c = LARGE
    n, eps, tilt = c["n"], cases_usfft.LAMINO_EPS, cases_usfft.LAMINO_TILT
    theta = cases_usfft.lamino_theta(c["ntheta"]).numpy()
    # bench_all.py's volume at this size, drawn on the card: a Gaussian-
    # windowed random complex volume.
    gen = torch.Generator(device=device).manual_seed(26)
    r2 = (torch.arange(n, device=device, dtype=torch.float32) - n / 2) ** 2
    volume = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=gen)
    volume *= torch.exp(-(r2[:, None, None] + r2[None, :, None] + r2[None, None, :]) / (n / 3) ** 2)
    volume = volume.cpu().numpy()
    out = {}
    for window in ("kb", "gaussian"):
        tag = f"large-lamino {window}"
        kwargs = dict(eps=eps, upsample=c["upsample"], kernel=window, device=device)
        stages = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            _stage(stages, f"{window}: start")
            data = tl.simulate(volume, theta, tilt, **kwargs)
            _stage(stages, f"{window}: simulate ({data.nbytes} bytes of data)")
            cfg = ops_lamino.LaminoConfig(n=n, tilt=float(tilt), eps=eps, upsample=c["upsample"],
                                          kernel=window)
            th = torch.as_tensor(theta, device=device)
            plan = LaminoPlan(cfg, th)
            plans = {id(p): p for p in (plan.gather, plan.scatter, plan.scatter_negated)}
            _stage(stages, f"{window}: plans ({sum(p.nbytes for p in plans.values() if p)} bytes)")
            u = torch.as_tensor(volume, device=device)
            d = ops_lamino.lamino_fwd(cfg, u, th, plan)
            _stage(stages, f"{window}: a forward")
            ops_lamino.lamino_adj(cfg, d, th, plan)
            _stage(stages, f"{window}: an adjoint")
            del plan, plans, u, d
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            start = time.perf_counter()
            warm = tl.reconstruct(data, theta, tilt, "cgrad", num_iter=1,
                                  cg_iter=LARGE_CG_ITER, **kwargs)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - start
            start = time.perf_counter()
            result = tl.reconstruct(data, theta, tilt, "cgrad", num_iter=LARGE_TIMED,
                                    cg_iter=LARGE_CG_ITER, **kwargs)
            torch.cuda.synchronize()
            timed_s = time.perf_counter() - start
            launches = _read_launches(tag)
            peak = torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError as error:
            log(f"[{tag}] {n}^3 at upsample {c['upsample']} does not fit the card: "
                f"{str(error).splitlines()[0]}; the stages until then: {stages}; "
                f"{torch.cuda.memory_allocated()} bytes allocated, "
                f"{torch.cuda.memory_reserved()} reserved ({card})")
            out[window] = None
            torch.cuda.empty_cache()
            continue
        costs = result["cost"]
        if not (len(costs) == LARGE_TIMED and np.all(np.isfinite(costs))
                and np.all(np.diff(costs) < 0)):
            raise AssertionError(f"{tag}: costs {costs} are not {LARGE_TIMED} finite falling values")
        if not np.all(np.isfinite(result["obj"])) or result["obj"].shape != volume.shape:
            raise AssertionError(f"{tag}: the volume is not finite or has the wrong shape")
        names = cases_usfft.COUNTS[window]
        if not all(launches[name] > 0 for name in names):
            raise AssertionError(f"{tag}: launched no {names} kernel: {launches}")
        per_iter = timed_s / LARGE_TIMED
        log(f"[{tag}] cgrad (cg_iter {LARGE_CG_ITER}) at {n}^3, {c['ntheta']} angles, upsample "
            f"{c['upsample']}: costs {costs.tolist()} (warm-up {warm['cost'].tolist()}); "
            f"{LARGE_TIMED} outer iterations in {timed_s:.3f} s = {per_iter:.3f} s/iteration; "
            f"first call {first_s:.3f} s, so set-up {first_s - per_iter:.3f} s; peak {peak} bytes; "
            f"launches { {k: launches[k] for k in usfft.LAUNCHES} } ({card})")
        out[window] = {name: launches[name] for name in names}
        del data, result, warm
    _reset_launches()
    phase_lamino_slices(device, WIDE_SLICE["upsample"], "gaussian", "wide-slice",
                        GAUSSIAN_SLICE_RUNS[1], WIDE_SLICE["eps"], WIDE_SLICE)
    wide = usfft.LAUNCHES["usfft_gather_gaussian"]
    if not wide > 0:
        raise AssertionError(f"wide-slice: launched no Gaussian gather: {usfft.LAUNCHES}")
    out["wide"] = wide
    return out


def _events_ms(fn, repeats: int = 20) -> float:
    """The mean time of ``fn`` on the card over ``repeats`` calls after
    one warm-up, from CUDA events."""
    fn()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return begin.elapsed_time(end) / repeats


def main() -> None:
    env = phase_environment()
    device = torch.device("cuda", 0)
    card = env["nvidia_smi"]
    parent_form = phase_build()
    timings = phase_kernel_parity(device, card)
    farplane_timings = phase_farplane_parity(device, card)
    path_shape_timings = phase_path_shapes(device, card)
    timings.update(phase_usfft_parity(device, card))
    scan, psi, probe = make_inputs(N_PATTERNS)
    phase_forward_model(device, scan, psi, probe)
    phase_small_slice(device)
    phase_small_slice(device, config2=True)
    phase_rpie_slices(device)
    main_path = phase_main_path(device, scan, psi, probe, env["nvidia_smi"])
    launches, main_epoch_s, main_breakdown = (
        main_path["launches"], main_path["epoch_s"], main_path["breakdown"]
    )
    launches2 = phase_config2(device, scan, psi, probe, env["nvidia_smi"])
    launches3 = phase_rpie(device, scan, psi, probe, env["nvidia_smi"])
    phase_siemens(device, env["nvidia_smi"])
    phase_lamino_slices(device)
    problem = lamino_problem(device)
    volume, theta, data = problem
    data_cpu = tl.simulate(volume, theta, cases_usfft.LAMINO_TILT, eps=cases_usfft.LAMINO_EPS,
                           upsample=1, device="cpu")
    err = _max_rel(data, data_cpu)
    if not err <= LAMINO_SIM_TOL:
        raise AssertionError(f"lamino: simulate on the card differs from the CPU's by {err:.3e}")
    log(f"[lamino] simulate {tuple(data.shape)} at {volume.shape[0]}^3 on the card vs the "
        f"CPU: max|err| / max|value| {err:.2e} (tol {LAMINO_SIM_TOL:g})")
    lamino_runs = {alg: phase_lamino(device, alg, card, problem) for alg in ("cgrad", "cgls")}
    lamino_launches = {alg: run["launches"] for alg, run in lamino_runs.items()}
    probe_launches, probe_timings = phase_probes(device, card, parent_form)
    phase_stream_slices(device)
    phase_stopping_slices(device)
    phase_admm_slice(device)
    launches_admm = phase_admm(device, card)
    launches_stream = phase_stream(device, card)
    phase_stream_compare(device, card)
    bucket_timings = phase_bucket_parity(device, card)
    phase_bucket_golden(device, card)
    bucket_run = phase_bucket(device, card)
    launches_bucket = bucket_run["launches"]
    launches_multigrid = phase_multigrid(device, scan, psi, probe, card)
    phase_ptycho_rest(device, scan, psi, probe, card)
    phase_multislice_slice(device)
    launches_multislice = phase_multislice(device, scan, probe, card)
    lanczos_timings = phase_lanczos_parity(device, card)
    phase_align_golden(device, card)
    launches_align = phase_align(device, card)
    phase_api_probes(device)
    launches_api, api = phase_api(device, scan, psi, probe, card, main_epoch_s, main_breakdown)
    phase_api_slice(device)
    phase_api_helpers(device, scan, psi, card, **api)
    del api
    mesh_start = time.perf_counter()
    phase_mesh_slice(device)
    mesh_main = phase_mesh_main(device, scan, psi, probe, card, main_path)
    launches_mesh = dict(mesh_main["launches"])
    lamino_mesh = phase_mesh_lamino(device, card, problem, lamino_runs["cgrad"])
    launches_mesh.update(lamino_mesh["launches"])
    slab_timings = phase_mesh_bucket_slabs(device, card, bucket_timings)
    bucket_mesh = phase_mesh_bucket(device, card, bucket_run)
    launches_mesh.update(bucket_mesh["launches"])
    phase_mesh_bucket_golden(device, card)
    phase_mesh_stream_slice(device)
    data_host = tp.simulate(DET, probe, scan, psi, device=device)
    launches_mesh_stream = phase_mesh_stream(device, scan, psi, probe, card, main_path, data_host)
    log(f"[mesh] phase 21 took {time.perf_counter() - mesh_start:.1f} s of the script's "
        f"{time.perf_counter() - SCRIPT_START:.1f} s ({card})")
    striped_start = time.perf_counter()
    phase_striped_slice(device)
    launches_striped, striped_run = phase_striped(device, scan, psi, probe, card, main_path,
                                                  data_host)
    del data_host
    log(f"[striped] phase 22 took {time.perf_counter() - striped_start:.1f} s of the script's "
        f"{time.perf_counter() - SCRIPT_START:.1f} s ({card})")
    dist_start = time.perf_counter()
    launches_dist, dist_gaussian_costs = phase_distributed(
        device, scan, psi, probe, card, mesh_main, striped_run, lamino_mesh, bucket_mesh)
    del striped_run
    log(f"[dist] phase 23 took {time.perf_counter() - dist_start:.1f} s of the script's "
        f"{time.perf_counter() - SCRIPT_START:.1f} s ({card})")
    examples_start = time.perf_counter()
    phase_examples_small(device)
    launches_examples = phase_examples(device, card)
    log(f"[examples] phase 24 took {time.perf_counter() - examples_start:.1f} s of the script's "
        f"{time.perf_counter() - SCRIPT_START:.1f} s ({card})")
    gaussian_start = time.perf_counter()
    gaussian_timings = phase_gaussian_parity(device, card)
    gaussian_run = phase_gaussian_lamino(device, card, problem, lamino_runs["cgrad"])
    for upsample in GAUSSIAN_UPSAMPLES:
        phase_lamino_slices(device, upsample, "gaussian", "gaussian-slice",
                            GAUSSIAN_SLICE_RUNS[upsample])
    phase_gaussian_slice_orders(device)
    launches_gaussian_mesh = phase_gaussian_mesh(device, card, problem, dist_gaussian_costs)
    log(f"[gaussian] phase 25 took {time.perf_counter() - gaussian_start:.1f} s of the script's "
        f"{time.perf_counter() - SCRIPT_START:.1f} s ({card})")
    large_start = time.perf_counter()
    large_timings = phase_large_grid(device, card)
    wide_timings = phase_wide_window(device, card)
    large_lamino = phase_large_lamino(device, card)
    log(f"[large] phase 26 took {time.perf_counter() - large_start:.1f} s of the script's "
        f"{time.perf_counter() - SCRIPT_START:.1f} s ({card})")
    large_launches = lambda window, name: dict(
        launches_lamino_646=None if large_lamino[window] is None else large_lamino[window][name])
    later = lambda name: dict(
        launches_multislice=launches_multislice[name], launches_align=launches_align[name],
        launches_api=launches_api[name], launches_mesh=launches_mesh[name],
        launches_mesh_stream=launches_mesh_stream[name],
        **{f"launches_{run}": counts[name] for run, counts in launches_striped.items()},
        **{run: [ranks[name] for ranks in counts]
           for run, counts in launches_dist.items()},
        **{f"launches_examples_{example}": counts[name]
           for example, counts in launches_examples.items()},
    )
    admm_shape, stream_shape = list(cases.PATH_SHAPES)
    report = [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/patch.cu",
            "replaces": KERNELS[name],
            "launches": launches[name],
            "launches_config2": launches2[name],
            "launches_rpie": launches3[name],
            "launches_admm": launches_admm[name],
            "launches_stream": launches_stream[name],
            "launches_bucket": launches_bucket[name],
            **{
                f"launches_multigrid_{width}": counts[name]
                for width, counts in launches_multigrid.items()
            },
            "ms_admm_shape": path_shape_timings[admm_shape][name]["ms"],
            "bound_ms_admm_shape": path_shape_timings[admm_shape][name]["bound_ms"],
            "ms_stream_batch": path_shape_timings[stream_shape][name]["ms"],
            "bound_ms_stream_batch": path_shape_timings[stream_shape][name]["bound_ms"],
            **later(name),
            **timings[name],
        }
        for name in KERNELS
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/farplane.cu",
            "replaces": FARPLANE_KERNELS[name],
            "launches": launches[name],
            "launches_config2": launches2[name],
            "launches_rpie": launches3[name],
            **later(name),
            **farplane_timings[name],
        }
        for name in FARPLANE_KERNELS
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/usfft.cu",
            "replaces": USFFT_KERNELS[name],
            "launches": lamino_launches["cgrad"][name],
            "launches_lamino_cgrad": lamino_launches["cgrad"][name],
            "launches_lamino_cgls": lamino_launches["cgls"][name],
            "launches_admm": launches_admm[name],
            "launches_stream": launches_stream[name],
            "launches_bucket": launches_bucket[name],
            **later(name),
            **timings[name],
            **large_timings[name],
            **large_launches("kb", name),
        }
        for name in USFFT_KERNELS
    ] + [
        {
            "name": f"probe_{name}",
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/probe.cu",
            "replaces": PROBE_KERNELS[name],
            "launches": probe_launches[name],
            "launches_admm": launches_admm[f"probe_{name}"],
            "launches_stream": launches_stream[f"probe_{name}"],
            "launches_bucket": launches_bucket[f"probe_{name}"],
            **later(f"probe_{name}"),
            **probe_timings[name],
        }
        for name in PROBE_KERNELS
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/bucket.cu",
            "replaces": BUCKET_KERNELS[name],
            "launches": launches_bucket[name],
            "launches_bucket": launches_bucket[name],
            "launches_admm": launches_admm[name],
            "launches_stream": launches_stream[name],
            **later(name),
            **bucket_timings[name],
            **slab_timings[name],
        }
        for name in BUCKET_KERNELS
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/interp.cu",
            "replaces": INTERP_KERNELS[name],
            "launches": launches_align[name],
            **later(name),
            **lanczos_timings[name],
        }
        for name in INTERP_KERNELS
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/usfft_gaussian.cu",
            "replaces": GAUSSIAN_KERNELS[name],
            "launches": gaussian_run["launches"][name],
            "launches_lamino_gaussian_cgrad": gaussian_run["launches"][name],
            "launches_lamino_gaussian_cgls": gaussian_run["launches_cgls"][name],
            "launches_gaussian_mesh": launches_gaussian_mesh[name],
            **later(name),
            **gaussian_timings[name],
            **large_timings[name],
            **wide_timings[name],
            **large_launches("gaussian", name),
        }
        for name in GAUSSIAN_KERNELS
    ] + [
        {
            "name": WIDE_GATHER,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/usfft_gaussian.cu",
            "replaces": GAUSSIAN_KERNELS["usfft_gather_gaussian"],
            "launches": large_lamino["wide"],
            "launches_wide_slice": large_lamino["wide"],
            "library_ms": None,
            "card": card,
            **wide_timings[WIDE_GATHER],
        }
    ]
    log(env["nvidia_smi"])
    log(json.dumps({"kernels": report}))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        dist_worker(sys.argv[2:])
    else:
        main()
