"""Smoke run of the PyTorch/CUDA port (``xsdba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--merge-against LABEL=SOURCE[,NVCC_FLAG...]]...

``--merge-against`` builds another ``merge_kernel.cu`` (another commit's,
or this one with other flags) and phase 6 times its merge kernels in turns
with this checkout's (:func:`merge_against`).

Phases, each reported on lines of its own:

1. device: requires ``torch.cuda.is_available()``; prints the torch version
   and the card's name and power limit (``nvidia-smi``);
2. build: compiles every CUDA source under ``xsdba_tpu_torch/csrc/`` (one
   ``nvcc`` each, all at once);
3. kernel: each kernel against its plain PyTorch twin, on the card, on the
   inputs its path gives it: the lookup (K1) at the windowed adjust's short
   partition rows ([256, 367, 150], a warp a row) and at the monthly
   partition shape, the 2-D lookup (K2) at the headline [512, 54750] rows,
   both at one value a row, lengths on and off a multiple of 4 and around
   the short-row limit, nq = 1, 2, 50, 64 and values that start off 16
   bytes, each with every edge case it has (tables of 0, 1 and 2 nodes,
   tied nodes, values of +-inf, NaN and exactly on nodes), bit for bit; the
   bracketed lookup at [512, 54750] with the monthly brackets and at a
   small odd shape with random brackets (w = 0 and 1, g0 == g1); the fused
   multiply-add against its emulation by bit pattern (any NaN equal to any
   NaN) in f32 and f64 on every layout class its two kernels serve (the rows
   kernel: contiguous and 16-byte aligned, a view one value off 16 bytes,
   3 and 1 values, n % 4 = 3, a trailing and a leading broadcast, 0-dim
   operands; the strided fallback: a transposed operand; +-0, +-inf, NaN,
   subnormals, products that cancel against c) and at the shapes its paths
   give it (the heavy extraction's lerp on the operands phase 6 times, the
   QDM step's virtual index and lerp, the selection step's lerp on slices,
   ExtremeValues' operands); the row sort (K3), the level
   build (K5) and the window fold (K6) on the heavy path's slab of 512 rows
   (ref and hist of 256 sites), K3 also on its rows cut to 32 values and
   padded with +inf to 1024 (the warp sort at 1 and 32 values a lane) and
   to 2048 (the long-row variant), and the per-group merge (K4) on the
   window-5 path's slab, and every merge kernel again on slabs of dry-day
   pr, 45 % of the days ±0.0 (:func:`merge_tie_diffs`: K3 in f32, f64
   and long rows, K5 and K6 at window 31, K4 at window 5), each printing
   how many values differ by bit pattern (ROADMAP C32: the kernels and the
   twins order -0.0 below +0.0); the key–payload row sort (K7) on the selection
   path's stage-1 input (ref and hist of 224 sites, [448, 54750] ->
   [448, 65536]), on one row of 2^20, on rows with ties, +-0.0 and +inf,
   at a tile less one, a tile and a tile and one, and on all-equal rows,
   printing the keys that differ under ``==`` and whether the (key,
   payload) multisets are equal; and the second variants of the level
   build (merging in device memory) and of the fold (its merge buffer in
   the output row) at f64, window 31 and 900 values a row (m = 1024); the
   lookup's ``nearest`` method (K1 and K2) on every lookup case above and,
   with rank-like values in [0, 1] (exact 0 and 1, ties half way between
   nodes), at the two MBCn shapes ([192, 10950] nq 50 and
   [143616, 930] nq 20), under ``==``; the emission kernel (the selection
   engine's emit mode) against its twin by bit pattern: 8 sites of the
   selection data at windows 5 and 31, f32 and f64, finite and NaN-masked
   (two sites all NaN), wet-day rows of +-0.0 ties where the twin's 2
   slots overflow, synthetic labels (``emit_edge_operands``: 1, 12, 365,
   366 and 1023 groups, windows 1, 5 and 31, wrapping intervals, an all-NaN
   row, a group with no valid value, +-0.0 ties, chunks of 8192 and of 192
   values), and the selection path's first site chunk of its 448 rows;
   K1 (``linear`` and ``nearest``) on tables with +inf holes
   (:func:`holey_tables`: quantile-trained tables with NaN factors inside,
   ROADMAP C31) at the monthly partition's long rows, the windowed adjust's
   short rows and with the search's edges, and K2 on the long rows
   flattened, by bit pattern (any NaN equal to any NaN); K1 on the same
   tables with their nodes shuffled (:func:`shuffled_tables`, the general
   ranking), by bit pattern;
4. main path: ``QuantileDeltaMapping.train(...).adjust(...)`` on CUDA
   tensors of 512 sites x 150 noleap years, f32, ``nquantiles=50``,
   monthly groups; finite, its adjust one launch of the bracketed lookup
   and none of K1, and equal to the port's CPU path (both blend fused) on
   the first 8 sites at rtol = atol = 2e-6; then (4b) ``group="time"`` on
   the same data, through K2; then (4c) the device-copy cache: the public
   QDM train on the numpy arrays and two adjusts of the same sim, uploads
   counted (2, 1, 0: the second adjust uploads nothing), the two scen
   equal, the adjust timed by the host clock with the cached sim and with
   the cache cleared before each call; (4d) the signs of zero
   (:func:`c29_phase`); (4e) C31 through the public path
   (:func:`c31_phase`): a dayofyear + 31 QDM, ``kind="*"``, on numpy
   dry-day pr of 512 sites x 150 years, adjusted with ``nearest`` and
   ``linear`` through K1 on tables with +inf holes, the first 8 sites'
   trained factors (ROADMAP C32) and scen equal to the CPU port's by bit
   pattern;
5. heavy: ``EmpiricalQuantileMapping.train(group="time.dayofyear",
   window=31).adjust(interp="linear")`` on CUDA tensors of 256 sites x 150
   noleap years (``bench.py``'s heavy data: seed 1, ref ~ N(10, 2), hist ~
   N(12, 3), sim ~ N(13, 3), f32, ``nquantiles=50``); finite, through K3,
   K5, K6, K1 and the fma kernel, and equal on the first 4 sites to the port's CPU merge
   path at rtol = atol = 2e-6, and in float64 to the re-sort oracle
   (``eqm_train_from_raw`` + ``qm_adjust_core``) at 1e-12; then the same at
   window 5, through K3 and K4;
   5b. selection: the same public call under
   ``set_options(selection_on_tpu=True, selection_mode="gather")`` on
   NUMPY inputs of 224 sites x 150 years of the heavy recipe (numpy data
   runs on the card by default); a CUDA result, finite, through K7 and K1
   and no merge kernel, equal on the first 4 sites to the port's CPU path
   and to the re-sort oracle; again on a NaN-masked copy (2 sites all NaN,
   10 % of the values of 4 more NaN), first 8 sites; both again in the
   default mode (``"auto"``, which on CUDA is emit) and the finite one
   under ``selection_mode="emit"``: through K7, the emission kernel and K1
   and no merge kernel, NaN exactly where the data is missing, scen ``==``
   to the gather engine's on every value;
   5c. multivariate (numpy inputs, so on the card): MBCn-a, ``bench.py``'s
   workload (64 sites x 3 variables x 30 noleap years, N(10, 3) f32 from
   numpy seeds 1 and 2, ``group="time"``, nq 50, 20 rotations,
   ``n_escore=-1``), and MBCn-b, the documented usage at a width that fills
   the card (256 sites, ``Grouper("time.dayofyear", window=31)``, nq 20: two
   chunks of group blocks): public ``MBCn.train`` then ``.adjust``; finite,
   K2 launched ``n_iter`` times a chunk by train and ``n_iter + V`` times a
   chunk by adjust (asserted), ``fma`` launched, no other kernel of the
   port; against the port's CPU path with the card's rotations injected on
   the first sites: ``af_q`` within 5e-5 over the first 3 iterations, and
   the share of (site, block) trajectories that stay within 5e-5 through
   all 20 (float32 states part when an ulp moves a rank across a node of
   the nearest lookup); every ``scen`` value is exactly one of its block's
   univariate QDM values (``group="time"``: each variable's series is a
   permutation of its QDM series, and its multiset equals the CPU port's);
   then a small ``NpdfTransform`` (8 sites x 2000 days, monthly QDM base,
   ``n_escore=0``: K1 with ``nearest``) and ``Scaling`` / ``LOCI`` at 512
   sites x 150 yr, monthly, linear, against the CPU port;
   5d. DQM (numpy inputs, so on the card): BASELINE config 2, daily pr at
   512 sites x 150 noleap years (:func:`pr_problem`),
   ``DetrendedQuantileMapping.train(kind="*", group="time.month",
   nquantiles=50, adapt_freq_thresh="1 mm/d",
   jitter_under_thresh_value="0.01 mm/d")`` then ``.adjust(interp="nearest",
   detrend=LoessDetrend(group="time", kind="*", f=0.2, niter=1, d=0))``
   (the FFT core, 5478 edge points a side); and ``group="time.dayofyear",
   window=31`` on the heavy data (``kind="+"``, nq 50, ``detrend=1``: the
   merge engine and a polynomial trend a windowed group).  Each is finite,
   its launches asserted (config 2: one K1 launch, ``nearest`` on the
   monthly partition's long rows, and no other kernel: every multiply-add
   of that path is eager in the JAX package, so none is fused; dayofyear +
   31: K3, K5, K6, fma and K1), and equal on the first 4 sites to the
   port's CPU path (the same draws, :class:`SeededDraws`): the trend at
   1e-5, scen at 1e-5 but for the values whose nearest node moved (rank
   flips, counted and printed, at most 1 %); then the LOESS trend alone at
   [512, 54750] on the card against the CPU port, interior and edges apart;
   5e. second-order and multivariate transforms through the public calls on
   numpy inputs (:func:`second_order_phase`): ``ExtremeValues.train(ref,
   hist, cluster_thresh="1 mm/d", q_thresh=0.95).adjust(sim, scen,
   frac=0.70, power=3)`` on config 2's data with 5d's DQM ``scen`` as the
   first-order scen: its outputs on the card, finite wherever scen is, the
   ``fma`` kernel launched and no other (its table lookup has 2874 nodes:
   plain PyTorch, as in the JAX package), against the CPU port on the first
   8 sites (the threshold at 1e-6, the fitted ref shape within 5e-3 with
   the sites beyond it counted, factors and scen at 1e-2 relative: ROADMAP
   C18), its cores, the GPD fit alone and the public calls timed, the fit,
   the train core and the adjust core profiled;
   ``PrincipalComponents(crd_dim="multivar", group="time.month")`` on
   :func:`mbcn_problem` at 512 sites (config 4's recipe), both orientations,
   against the CPU port at 1e-3 (the eigensolvers' float32 rounding), no
   kernel of the port, ``pc_transform_matrix`` and the public calls timed;
   ``OTC`` and ``dOTC`` (also ``kind={"pr": "*"}``) at one site, monthly,
   estimated bin widths, ``solver="emd"`` (:func:`ot_problem`): the plans
   are host work in both packages, the result a tensor on the card, equal
   to the CPU port's on the same stream seed; the occupied bins a month
   printed; ``solver="sinkhorn"`` once, its plans on the card;
   5f. BASELINE config 5 (:func:`config5_phase`): QDM adjust plus the
   validation suite on a 2048-site tile of the 0.25 degree grid (32 lat x
   64 lon, ``lat`` / ``lon`` coords on the site dim), 150 noleap years of
   daily f32 tas (the headline recipe, an 8 K seasonal cycle, sim warmed by
   2 K) and pr (config 2's recipe), in four blocks of 512 sites
   (:func:`config5_block`): per block, public QDM train + adjust of tas
   (``kind="+"``) and pr (``kind="*"``, the jitter), monthly, nq 50, then
   the suite (:func:`config5_suite`: moments, the 98th percentile, trend,
   annual cycle, the 20-year return value by ML, spell lengths, wet-day
   frequency and persistence, the Spearman correlation of tas and pr) on
   ref, sim and scen and its measures of scen against ref; over the tile,
   the spatial correlogram, the decorrelation length and Scorr of tas.
   Every output finite where the reference's would be, the QDM kernels'
   launches asserted (one bracketed lookup an adjust), the first 8 sites
   equal to the port's CPU path on the same draws (moments, counts and
   frequencies at 2e-6, the trend at 1e-5 of the suite's largest trend,
   the return values at 1e-3, the tile's correlogram at 1e-4); the pipeline's gridpoint-years/s, the
   suite's share, each property's device time, launches and idle share,
   and peak memory;
   5g. the rest of the modules users call around the adjustments
   (:func:`a7_phase`), each on numpy inputs through its public calls, its
   launches counted around it and held against the CPU port: cubic QDM on
   the headline data (no lookup kernel launched, the spline in plain
   PyTorch; the first 8 sites at 2e-6; the adjust's time against linear,
   the slope solve's launches and time); cubic windowed EQM on the heavy
   data (the train through K3, K5, K6; the first 4 sites at 2e-6 against
   the CPU merge engine); the moving-window QDM (trained on 30 years;
   ``stack_periods(sim, window=30, stride=10)`` of 150 years, 13 periods,
   unstacked back under ==; the stack adjusted, linear, and unstacked,
   counted apart from the train: one bracketed lookup, whose launch also
   blends, and no other kernel; the three timed against the linear adjust
   of the series; the first 4 sites at 2e-6);
   MBCn at MBCn-a's width with config 2's pr as its second variable and
   ``adapt_freq_thresh`` + ``jitter_under_thresh_value`` in
   ``base_kws_vars`` (K2 ``nearest`` launched 2 x 20 + 3 times; scen a
   reordering of each variable's univariate QDM; the first rotation's
   factors at 5e-5 of the CPU port on the same draws); the log transform
   of config 2's pr into the additive space and back (2e-6 of the CPU port
   and of the data); the spectral filter on config 3's 100 x 100 grid at
   0.25 degrees x 30 years (delta estimated from ``lat``; the first 365
   days at 2e-6 of the field's scale; profiled); the host-to-device copy
   of one numpy [512, 54750] f32 array; the public ``interp_on_quantiles``
   at the headline shape, grouped (K1) and ungrouped (K2), equal to the CPU
   port under ==; each with its time, launches and peak memory beside the
   card's name and power limit;
5h. the shell modules users call around the schemes (:func:`shell_phase`):
   ``cli.main(["selftest"])`` on the card (0, its residual equal to the CPU
   port's to 1e-6); ``nbutils.quantile`` over ``time`` of the headline sim
   (numpy [512, 54750] f32, nq 50) and ``nbutils.vecquantiles`` at ranks
   drawn from numpy seed 0, each on the card, its first 8 sites equal to
   the CPU port's under ==, timed by the host clock with the host-to-device
   copy in it; ``base.map_groups`` of a monthly mean of the same sim on the
   card (the first 8 sites at 2e-6 of the CPU port); ``utils.profiling.trace``
   around the public train and adjust of the heavy windowed EQM (merge
   engine), whose Chrome trace must name K3, K5, K6 and K1
   (``sort_rows_warp_kernel``, ``build_levels_kernel``,
   ``fold_windows_kernel``, ``interp_rows_kernel``); phase 6 times the
   fused QDM step with ``utils.profiling.timed`` beside its CUDA-event
   median, and ``timed``'s best is at least the events' least sample;
5i. the parallel layer (:func:`parallel_phase`, ``xsdba_tpu_torch/parallel``)
   under one NCCL rank, for correctness only (one card: no speed across
   cards): ``site_mesh("cuda")`` with no launcher forms a one-rank world;
   the headline QDM step through ``shard_sites`` and the site mesh equal to
   the direct core under ==; ``sharded_pairwise_corr`` on config 5's
   2048-site tile (daily tas ref, f64, [2048, 54750]) against the
   one-process product at 1e-12; ``sharded_first_eof`` on the tile's annual
   means [2048, 150] against ``ops/pca.py:first_eof_pattern`` at atol 1e-10;
   ``sharded_rotation_apply`` on a (1, 1) site x var mesh at MBCn-b's shape
   against ``torch.matmul`` at 1e-6 (f32); each hold with its wall time;
6. times (2 warm-ups, median of 5 and the spread): the fused QDM, windowed
   EQM (merge) and selection steps (at 224 sites the gather engine, the
   default mode's emit engine and the merge engine in turns; the emit
   step's peak memory above the held, under 2 GiB) in gridpoint-years/s
   (CUDA events), the
   public calls on the same data (host clock; here and in every phase, a
   call timed by the host clock repeatedly starts from an empty device-copy
   cache, so it uploads its numpy inputs as before the cache, and only
   phase 4c's cached adjust reuses a copy), each kernel against its twin
   (CUDA events, in turns; a kernel's sample is the mean of 10 calls queued
   behind a spin of the card, so the host's launch cost stays out of it)
   and against one PyTorch call computing the same function where there is
   one (timed the same way; K7's ``torch.sort`` sorts the keys alone,
   without the payload; K5's sorts the top level's runs, one of its four
   levels; fma's is ``torch.addcmul``, timed in turns with the kernel), K1 also on the monthly
   partition's long rows, fma also on same-shape operands and in float64,
   K3's long-row variant at m = 2048, K1 on tables with +inf holes beside
   the same values on ordered tables (each method, in turns), with
   ``--merge-against`` the merge kernels of each other build in turns with
   this checkout's (:func:`merge_against`), the peak device memory of
   the heavy and selection steps and of the heavy public call, the MBCn-a
   and MBCn-b train steps (``_mbcn_train_block``; MBCn-b's on its first
   chunk of blocks) in training iterations/s with their peak memory, the
   lookup's ``nearest`` method beside ``linear`` on the same inputs, the DQM
   steps in gridpoint-years/s (config 2's train: jitter, adapt_freq and
   ``dqm_train_core``; the windowed train ``dqm_train_windowed``; each
   adjust's quantile-mapping step) with their peak memory, the LOESS and
   PolyDetrend trends alone, the public DQM train and adjust calls (host
   clock), and for each fused step, config 2's public adjust and the two
   trends the five kernels that take the most device time plus the port's
   own kernels (``torch.profiler``).

Each path's kernel launches are counted from 0 just before it runs and read
just after; launches made to compare a kernel with its twin do not count.
Each merge wrapper counts one launch a call (the level build builds every
level in one launch).
The line before the last is one JSON object describing the kernels (K1's
launches and shape are the heavy path's windowed adjust, K2's the
``group="time"`` path's, K3, K5 and K6's the heavy path's, K4's the
window-5 path's, K7's the selection path's, the bracketed lookup's the QDM
path's, fma's the heavy path's, at its extraction's broadcast lerp; the
``nearest`` rows: K2's launches and shape are MBCn-b's, K1's launches the
small NpdfTransform's and its timed shape the windowed adjust's, the same
as its ``linear`` row; ``K1 nearest (long rows)``: config 2's launches, at
its monthly partition shape [512, 14, 4650]; the emission's launches are
5b's finite emit run, its shape one site chunk of that run), each
with its least possible time on an H100 (``bound_ms``: the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s); the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import xsdba_tpu_torch as xp
from xsdba_tpu_torch import processing
from xsdba_tpu_torch.models._algos import (
    dqm_train_core,
    dqm_train_windowed,
    eqm_train_adjust_windowed,
    eqm_train_from_raw,
    qdm_train_adjust_core,
    qm_adjust_core,
)
from xsdba_tpu_torch.models import _wrap, extremes, mbcn, otc
from xsdba_tpu_torch.models import pca as pca_mod
from xsdba_tpu_torch.models.dqm import _scaled
from xsdba_tpu_torch.models._wrap import device_brackets
from xsdba_tpu_torch.ops import merge, sort
from xsdba_tpu_torch.ops.clusters import cluster_maxima
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes
from xsdba_tpu_torch.ops.cuda import _build, emit_kernel, fma_kernel, interp_kernel
from xsdba_tpu_torch.ops.detrend import grouped_polyfit_trend
from xsdba_tpu_torch.ops.fitting import gpd_fit_ml
from xsdba_tpu_torch.ops.interp import _compact_nan_pairs
from xsdba_tpu_torch.ops.loess import loess_smoothing
from xsdba_tpu_torch.ops.pca import pc_transform_matrix
from xsdba_tpu_torch.ops.quantile import merge_slab
from xsdba_tpu_torch.ops.rotation import rand_rot_matrix
from xsdba_tpu_torch.ops.segment import gather_groups
from xsdba_tpu_torch.ops.selquant import _emit_operands, default_sort_impl, max_chunk, plan_labels
from xsdba_tpu_torch.parallel.dryrun import example_problem, monthly_qdm_step  # the headline recipe and step
from xsdba_tpu_torch.utils import profiling

N_SITES, N_YEARS, NQ = 512, 150, 50
CHECK_SITES = 8
# the emission's synthetic cases: group counts (1023 is the label packing's
# largest) and values a row
EMIT_EDGE_GROUPS, EMIT_EDGE_T = (1, 12, 365, 366, 1023), 9000
HEAVY_SITES, HEAVY_YEARS, HEAVY_WINDOW = 256, 150, 31
HEAVY_CHECK = 4
SMALL_WINDOW = 5
# the selection path: the most sites the fused selection step takes at
# nq = 50 (2 * S * 365 * 101 * 128 <= 2^31), a multiple of 8
SEL_SITES, SEL_CHECK, SEL_NAN_CHECK = 224, 4, 8
# the emission kernel against its twin: sites of the selection data (ref and
# hist: twice as many rows), and the wet-day rows where the twin's slots
# overflow; the emit step's peak above what is held stays under EMIT_PEAK
EMIT_CHECK, EMIT_WET_ROWS, EMIT_WET_SLOTS, EMIT_PEAK = 8, 8, 2, 2 << 30
TOL = dict(rtol=2e-6, atol=2e-6)
# the multivariate paths: bench.py's MBCn workload (a) and the documented
# dayofyear usage at a width that fills the card (b)
MBCN_VARS, MBCN_YEARS, MBCN_ITERS = 3, 30, 20
MBCN_A = dict(sites=64, group=("time", 1), nq=50, check=8)
MBCN_B = dict(sites=256, group=("time.dayofyear", 31), nq=20, check=2)
MBCN_AF_TOL, MBCN_FIRST = 5e-5, 3
NPDF_SITES, NPDF_DAYS, NPDF_ITERS = 8, 2000, 5
# BASELINE config 2: DQM on daily pr, multiplicative, monthly, LOESS
# detrending, with the dry-day preprocessing its users pass (without the
# jitter, kind="*" divides zero quantiles by zero quantiles: the JAX package
# leaves most of scen NaN on this data)
PR_SITES, PR_YEARS, PR_CHECK = 512, 150, 4
PR_TRAIN = dict(kind="*", group="time.month", nquantiles=NQ, adapt_freq_thresh="1 mm/d", jitter_under_thresh_value="0.01 mm/d")
LOESS_KW = dict(f=0.2, niter=1, d=0)
# the card against the CPU port: a value whose nearest node moved is a rank
# flip (an ulp of the detrended value across a half-way point); the rest
# are held at FLIP_RTOL, the flips to at most MAX_FLIPS of the values
FLIP_RTOL, MAX_FLIPS = 1e-5, 0.01
LOESS_RTOL = 1e-5
# ExtremeValues on config 2's first-order scen (the current defaults, passed
# explicitly).  Against the CPU port, every site checked: the threshold at
# EV_THRESH_RTOL, the fitted ref shape within EV_FIT_TOL (the GPD fit is
# fixed only to about sqrt(eps), ROADMAP C18), the factors and scen at
# EV_RTOL
EV_TRAIN = dict(cluster_thresh="1 mm/d", q_thresh=0.95)
EV_ADJUST = dict(frac=0.70, power=3)
EV_THRESH_RTOL, EV_FIT_TOL, EV_RTOL = 1e-6, 5e-3, 1e-2
# PrincipalComponents at config 4's recipe (mbcn_problem(512)): the card's
# eigensolver against the CPU's, float32
PCA_SITES, PCA_RTOL = 512, 1e-3
# OTC / dOTC: one site, the e2e recipe's two variables over 30 years
OT_YEARS, OT_SEED = 30, 11
# BASELINE config 5: a 2048-site tile of the 0.25 degree grid (32 x 64
# points from 40.125 N, 0.125 E), run in blocks of 512 sites; block b's
# tas comes from numpy seed C5_SEED + b, its pr from C5_SEED + 10 + b
# (ref, hist) and C5_SEED + 20 + b (sim); checked on the first 8 sites
C5_LAT, C5_LON, C5_BLOCK, C5_YEARS, C5_SEED = 32, 64, 512, 150, 50
C5_SITES = C5_LAT * C5_LON
C5_RTOL, C5_TREND_RTOL, C5_FIT_RTOL, C5_CORRELOGRAM_TOL = 2e-6, 1e-5, 1e-3, 1e-4
# H100 SXM peaks: HBM bytes/s, float32 FLOP/s
PEAK_BYTES, PEAK_OPS = 3.35e12, 67e12
# a kernel's time: the mean of KERNEL_BATCH back-to-back calls, queued
# behind a spin of SPIN_CYCLES (~10 ms) while the host launches them
KERNEL_BATCH, SPIN_CYCLES = 10, 20_000_000
_SRC = "xsdba_tpu_torch/csrc/"
_PALLAS = "xsdba_tpu/ops/pallas/"
KERNELS = {
    "K1": dict(name="interp_table_3d", route="cuda", source=_SRC + "interp_kernel.cu", replaces=_PALLAS + "interp_kernel.py:101"),
    "K2": dict(name="interp_table_2d", route="cuda", source=_SRC + "interp_kernel.cu", replaces=_PALLAS + "interp_kernel.py:141"),
    "K3": dict(name="sort_rows_alternating", route="cuda", source=_SRC + "merge_kernel.cu", replaces=_PALLAS + "merge_kernel.py:171"),
    "K4": dict(name="merged_window_rows", route="cuda", source=_SRC + "merge_kernel.cu", replaces=_PALLAS + "merge_kernel.py:271"),
    "K5": dict(name="build_levels", route="cuda", source=_SRC + "merge_kernel.cu", replaces=_PALLAS + "merge_kernel.py:477"),
    "K6": dict(name="fold_windows", route="cuda", source=_SRC + "merge_kernel.cu", replaces=_PALLAS + "merge_kernel.py:636"),
    "K7": dict(name="sort_rows_with_payload", route="cuda", source=_SRC + "sort_kernel.cu", replaces=_PALLAS + "sort_kernel.py:134"),
    # not TPU kernels: the partition route of the reference's grouped lookup in
    # one launch, and the fused multiply-add XLA's contraction gives the reference
    "bracketed": dict(name="interp_bracketed", route="cuda", source=_SRC + "interp_kernel.cu", replaces="xsdba_tpu/ops/interp.py:409"),
    "fma": dict(name="fma", route="cuda", source=_SRC + "fma_kernel.cu",
                replaces="xsdba_tpu/ops/quantile.py:35 (x * y + z as XLA contracts it in the compiled programs)"),
    # the row lookups' second method: the same kernel, no Pallas kernel serves it in the reference
    "K1 nearest": dict(name="interp_table_3d[nearest]", route="cuda", source=_SRC + "interp_kernel.cu", replaces=_PALLAS + "interp_kernel.py:101"),
    "K2 nearest": dict(name="interp_table_2d[nearest]", route="cuda", source=_SRC + "interp_kernel.cu", replaces=_PALLAS + "interp_kernel.py:141"),
    "K1 nearest (long rows)": dict(name="interp_table_3d[nearest, long rows]", route="cuda", source=_SRC + "interp_kernel.cu", replaces=_PALLAS + "interp_kernel.py:101"),
    # the selection engine's dense emission: plain JAX in the reference, no Pallas kernel
    "emit": dict(name="emit", route="cuda", source=_SRC + "emit_kernel.cu",
                 replaces="xsdba_tpu/ops/selquant.py:336 (the emit mode's _window / _run / _chunk_emit / _assemble, plain JAX)"),
}


def lookup_inputs(B, Gp, Lp, nq, seed=0, device="cpu", extra=False):
    """Compacted f32 lookup tables [B, Gp, nq] and values [B, Gp, Lp] with
    the lookup's edge cases: NaN pairs inside tables, whole-NaN rows
    (nvalid = 0), single-node rows with values exactly on the node (and a
    NaN y in the pad slot), NaN values, and values below and above each
    table.  ``extra`` adds what a binary search must get right, on the same
    draws: two-node rows, tied nodes, values of +-inf and values exactly on
    nodes and on the +inf pads (off by default: the timed inputs stay
    continuous data with 1 % missing, as the paths give it).  Returns
    (v, xs, ys, nvalid int32) on ``device``."""
    rng = np.random.default_rng(seed)
    R = B * Gp
    xq = np.sort(rng.normal(0, 1, (R, nq)), axis=-1)
    yq = rng.normal(0, 1, (R, nq))
    rows = rng.permutation(R)
    k = max(R // 50, 1)
    nan_pair, empty, single, pair, tied = (rows[i * k : (i + 1) * k] for i in range(5))
    xq[nan_pair, rng.integers(0, nq, k)] = np.nan
    yq[nan_pair, rng.integers(0, nq, k)] = np.nan
    xq[empty] = np.nan
    xq[single, 1:] = np.nan
    yq[single, 1:] = np.nan
    if extra:
        xq[pair, 2:] = np.nan
        if nq >= 3:
            xq[tied, nq // 2 - 1] = xq[tied, nq // 2 + 1] = xq[tied, nq // 2]
    xs, ys, nv = _compact_nan_pairs(torch.as_tensor(xq, dtype=torch.float32), torch.as_tensor(yq, dtype=torch.float32))
    v = rng.normal(0, 3, (R, Lp)).astype(np.float32)   # ~half outside [x_first, x_last]
    v[rng.random((R, Lp)) < 0.01] = np.nan
    if extra:
        v[:, 3::11] = np.take_along_axis(xs.numpy(), rng.integers(0, nq, v[:, 3::11].shape), axis=-1)  # on nodes and pads
        special = rng.random((R, Lp))
        v[special < 0.002] = np.inf
        v[(special >= 0.002) & (special < 0.004)] = -np.inf
    v[single, ::7] = xs[single, :1].numpy()             # exactly on the single node
    shape = lambda a, *tail: a.reshape(B, Gp, *tail).contiguous().to(device)  # noqa: E731
    return shape(torch.from_numpy(v), Lp), shape(xs, nq), shape(ys, nq), shape(nv.to(torch.int32))


def rank_lookup_inputs(R, L, nq, seed=0, device="cpu"):
    """The multivariate path's lookup inputs: ``R`` rows of ``L`` rank-like
    f32 values in [0, 1] (each row a permutation of k / (L - 1), so exactly
    0 and 1 occur, the permutations repeating after 2048 rows; every 13th
    value half way between two nodes, a tie; 1 % NaN) against ``equally_spaced_nodes(nq)`` with factors ~ N(0, 1).
    Returns (v [R, L], xs [R, nq], ys [R, nq], nvalid [R] int32)."""
    rng = np.random.default_rng(seed)
    nodes = equally_spaced_nodes(nq).astype(np.float32)
    base = min(R, 2048)   # distinct permutations; further rows repeat them against their own factors
    v = (rng.permuted(np.tile(np.arange(L, dtype=np.float64), (base, 1)), axis=1) / max(L - 1, 1)).astype(np.float32)
    v = v[np.arange(R) % base]
    if nq > 1:
        mid = (nodes[:-1] + nodes[1:]) / 2
        v[:, 5::13] = mid[rng.integers(0, nq - 1, v[:, 5::13].shape)]
    v[:, 0], v[:, -1] = 0.0, 1.0
    v[rng.random((R, L)) < 0.01] = np.nan
    v[0, 0], v[0, -1] = 0.0, 1.0
    xs = np.tile(nodes, (R, 1))
    ys = rng.normal(0, 1, (R, nq)).astype(np.float32)
    nv = np.full(R, nq, np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (v, xs, ys, nv))


def bracket_inputs(B, Gp, nq, g0, g1, w, seed=0, device="cpu", extra=False):
    """Inputs of the bracketed lookup over the [T] brackets (g0, g1, w):
    values [B, T] and padded tables [B, Gp, nq] with the edge cases of
    :func:`lookup_inputs` (``extra`` as there).  Returns (v, xs, ys, nvalid,
    g0 int32, g1 int32, w f32) on ``device``."""
    T = len(g0)
    v, xs, ys, nv = lookup_inputs(B, Gp, -(-T // Gp), nq, seed=seed, extra=extra)
    v = v.reshape(B, -1)[:, :T].contiguous()
    steps = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype).contiguous()  # noqa: E731
    return tuple(a.to(device) for a in (v, xs, ys, nv, steps(g0, torch.int32), steps(g1, torch.int32), steps(w, torch.float32)))


def random_brackets(T, Gp, seed):
    """[T] brackets over Gp groups with w = 0 and 1 and g0 == g1 among them."""
    rng = np.random.default_rng(seed)
    g0 = rng.integers(0, Gp, T)
    g1 = np.where(rng.random(T) < 0.2, g0, rng.integers(0, Gp, T))
    w = rng.random(T)
    w[::5], w[1::5] = 0.0, 1.0
    return g0, g1, w


def off_16(a, words=1):
    """A contiguous copy of ``a`` that starts ``words`` 4-byte words past a
    16-byte boundary."""
    b = torch.cat([a.new_zeros(words), a.reshape(-1)])[words:].reshape(a.shape)
    assert b.is_contiguous() and b.data_ptr() % 16 == 4 * words
    return b


def holey_tables(B, Gp, nq, seed=0):
    """Quantile-like tables [B, Gp, nq] as the grouped adjust's fast path
    lays out trained tables with NaN factors inside (``kind="*"`` on dry
    days: 0 / 0): ``ops/interp.py:_compact_sorted_tables`` of ascending
    nodes whose factor is NaN on a leading run (up to a third of the
    nodes) and on 10 % of the others, so the nodes carry +inf holes where
    the lookup counts by value and takes the segment by position (ROADMAP
    C31); some rows whole NaN.  Returns (xs, ys, nvalid int32)."""
    from xsdba_tpu_torch.ops.interp import _compact_sorted_tables

    rng = np.random.default_rng(seed)
    xq = np.sort(rng.normal(0, 1, (B, Gp, nq)), axis=-1).astype(np.float32)
    yq = rng.normal(0, 1, (B, Gp, nq)).astype(np.float32)
    lead = rng.integers(0, nq // 3 + 1, (B, Gp))
    yq[np.arange(nq) < lead[..., None]] = np.nan
    yq[rng.random((B, Gp, nq)) < 0.1] = np.nan
    yq[rng.random((B, Gp)) < 0.02] = np.nan
    xs, ys, nv = _compact_sorted_tables(torch.from_numpy(xq), torch.from_numpy(yq))
    return xs.contiguous(), ys.contiguous(), nv.to(torch.int32)


def shuffled_tables(xs, ys, seed=0):
    """Tables [..., nq] whose (x, y) pairs are shuffled within each row: nodes
    in no order at all, which the lookups' twins accept too (K1 ranks such a
    row by nq comparisons a node, not by its ballots for +inf holes)."""
    g = torch.Generator().manual_seed(seed)
    order = torch.argsort(torch.rand(xs.shape, generator=g), dim=-1).to(xs.device)
    return torch.take_along_dim(xs, order, -1).contiguous(), torch.take_along_dim(ys, order, -1).contiguous()


# the bracketed kernel's edge cases (bracket_cases): (sites, T, Gp, nq) with
# random brackets, then inputs laid out off 16 bytes and group ids outside
# [0, Gp)
_CHUNK = 8 * 1024   # interp_kernel.BRACKETED_CHUNK
BRACKET_SHAPES = ((2, 1, 3, 2), (3, 3, 14, 1), (3, 1001, 1, 49), (4, 1500, 14, 62), (5, 2049, 14, 63), (3, 3001, 14, 64), (2, 5003, 46, 64),
                  (2, 4099, 46, 49), (3, _CHUNK, 14, 50), (2, 2 * _CHUNK, 14, 2), (2, _CHUNK + 3, 46, 63), (4, 777, 14, 1))
BRACKET_CASES = tuple(f"nq={nq} Gp={gp} T={T}" for _, T, gp, nq in BRACKET_SHAPES) + (
    "values 4 bytes off 16", "values 8 bytes off 16", "steps 4 bytes off 16", "group ids outside [0, Gp)",
    "tables with +inf holes nq=50 Gp=14", "tables with +inf holes nq=64 Gp=46")


def bracket_cases(device, only=None):
    """The bracketed kernel's edges, {label: its arguments} (the labels
    ``BRACKET_CASES``, or only the one named), all with the search's edges
    (``bracket_inputs(..., extra=True)``) and random brackets: every search
    depth and its boundary (nq 1, 2, 49, 62, 63, 64), Gp 1, 14 and 46, rows of
    one value, shorter than a chunk, of a length not a multiple of 4 and of
    exactly one and two chunks (``interp_kernel.BRACKETED_CHUNK``), values 4
    and 8 bytes off a 16-byte boundary, step arrays off 16 bytes, and group
    ids outside [0, Gp), and tables with +inf holes (:func:`holey_tables`)."""
    assert interp_kernel.BRACKETED_CHUNK == _CHUNK
    cases = {}
    for (B, T, gp, nq), label in zip(BRACKET_SHAPES, BRACKET_CASES):
        if only in (None, label):
            cases[label] = bracket_inputs(B, gp, nq, *random_brackets(T, gp, seed=T + gp), seed=B + T + nq, device=device, extra=True)
    if only is None or "off 16" in only:
        args = bracket_inputs(3, 14, 50, *random_brackets(4001, 14, seed=5), seed=6, device=device, extra=True)
        cases["values 4 bytes off 16"] = (off_16(args[0]), *args[1:])
        cases["values 8 bytes off 16"] = (off_16(args[0], 2), *args[1:])
        cases["steps 4 bytes off 16"] = (*args[:4], *(off_16(a) for a in args[4:]))
    if only in (None, "group ids outside [0, Gp)"):
        v, xs, ys, nv, g0, g1, w = (a.clone() for a in bracket_inputs(5, 14, 50, *random_brackets(3001, 14, seed=1), seed=2, device=device, extra=True))
        g0[::97], g1[5::89], g0[7::101] = 14, -1, -3
        cases["group ids outside [0, Gp)"] = (v, xs, ys, nv, g0, g1, w)
    for gp, nq in ((14, 50), (46, 64)):
        label = f"tables with +inf holes nq={nq} Gp={gp}"
        if only in (None, label):
            v, _, _, _, g0, g1, w = bracket_inputs(4, gp, nq, *random_brackets(5001, gp, seed=nq), seed=nq + gp, device=device, extra=True)
            cases[label] = (v, *(a.to(device) for a in holey_tables(4, gp, nq, seed=gp)), g0, g1, w)
    return cases if only is None else {only: cases[only]}


def fma_inputs(n, dtype, seed=0, device="cpu"):
    """Three [n] operands of ``fma`` with its edge cases: scales from 2^-20
    to 2^20, +-0, +-inf, NaN, subnormals, and products that cancel against
    ``c`` (c = -(a * b) rounded, so the fused result is the product's
    rounding error).  In float64 the subnormals stay in ``c``: the emulation
    is exact only while the product's error term is representable."""
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a, b, c = ((rng.normal(0, 1, n) * 2.0 ** rng.integers(-20, 21, n)).astype(npdt) for _ in range(3))
    c[::3] = -(a[::3] * b[::3])
    tiny = np.finfo(npdt).smallest_subnormal
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, tiny, -tiny, 37 * tiny, np.finfo(npdt).tiny / 2], npdt)
    for i, x in enumerate((a, b, c)):
        at = rng.choice(n, max(n // 20, 1), replace=False)
        pick = specials if (dtype == torch.float32 or i == 2) else specials[:5]
        x[at] = rng.choice(pick, len(at))
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, c))


def extremes_fma_inputs(S, T, dtype, seed=0, device="cpu"):
    """``fma``'s operands on ExtremeValues' path at its shapes and strides,
    with values like the path's: {label: (a, b, c)}.  The golden-section
    points (``ops/fitting.py:gpd_fit_ml``: the 0-d ratio expanded over a
    [S, 1] bracket width, as the fit writes them), the CDF's ``1 + c z``
    (c [S, 1] expanded over z [S, T], zeros for the dry days), the quantile
    function's ``loc + scale z`` (scale and loc [S, 1] expanded over
    [S, T], z NaN off the tail) and the final blend ``transition * scen_ext
    + (1 - transition) * scen`` ([S, T] each, transition 0 below the
    threshold)."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=device, dtype=dtype)  # noqa: E731
    gr = torch.tensor((5 ** 0.5 - 1) / 2, dtype=dtype, device=device)
    lo = -u(S, 1)
    width = 2 * u(S, 1)
    hi = lo + width
    c = u(S, 1) * 0.8 - 0.3
    z = torch.where(u(S, T) < 0.4, 0.0, -torch.log(u(S, T)))
    z[:, ::97] = torch.nan
    q = torch.where(u(S, T) < 0.95, torch.nan, u(S, T))
    zq = ((1 - q) ** -c - 1) / c
    scale, loc = 1 + 9 * u(S, 1), 5 + 25 * u(S, 1)
    tr = torch.clamp(u(S, T) * 2 - 1.5, min=0) ** 3
    ext, scen = 40 * u(S, T), 30 * u(S, T)
    return {
        "golden-section point c1": (-gr.expand_as(width), width, hi),
        "golden-section point c2": (gr.expand_as(width), width, lo),
        "GPD CDF 1 + c z": (c.expand_as(z), z, torch.ones_like(z)),
        "GPD PPF loc + scale z": (scale.expand_as(zq), zq, loc.expand_as(zq)),
        "final blend": (tr, ext, (1 - tr) * scen),
    }


def heavy_problem(n_sites, n_years):
    """The heavy data recipe (``bench.py:174-183``): the same distributions
    from seed 1, noleap days from 1950."""
    return example_problem(n_sites, n_years, seed=1, start="1950-01-01")


def _da(x, t, name):
    return xp.DataArray(x, ("site", "time"), {"time": t}, {"units": "K"}, name)


def run_main_path(ref, hist, sim, t):
    """The public QDM path on [site, time] tensors (on their device)."""
    qdm = xp.QuantileDeltaMapping.train(_da(ref, t, "ref"), _da(hist, t, "hist"), group="time.month", nquantiles=NQ, kind="+")
    return qdm.adjust(_da(sim, t, "sim"), interp="linear").data


def run_time_path(ref, hist, sim, t):
    """The public QDM path with one group (``group="time"``): its adjust
    looks sim's ranks up in one table per site (K2)."""
    qdm = xp.QuantileDeltaMapping.train(_da(ref, t, "ref"), _da(hist, t, "hist"), group="time", nquantiles=NQ, kind="+")
    return qdm.adjust(_da(sim, t, "sim"), interp="linear").data


def run_windowed_path(ref, hist, sim, t, window=HEAVY_WINDOW):
    """The public windowed EQM path (dayofyear groups, ``window`` days) on
    [site, time] data (tensors on their device, numpy on the default one)."""
    eqm = xp.EmpiricalQuantileMapping.train(
        _da(ref, t, "ref"), _da(hist, t, "hist"), group="time.dayofyear", window=window, nquantiles=NQ, kind="+"
    )
    return eqm.adjust(_da(sim, t, "sim"), interp="linear").data


def resort_oracle(ref, hist, sim, t, window=HEAVY_WINDOW):
    """Windowed EQM by the re-sort path: every group's window gathered and
    sorted (``eqm_train_from_raw``), then ``qm_adjust_core``."""
    gi = xp.Grouper("time.dayofyear", window=window).indexes(t)
    q = torch.as_tensor(equally_spaced_nodes(NQ), dtype=ref.dtype, device=ref.device)
    af, hist_q = eqm_train_from_raw(ref, hist, torch.as_tensor(gi.gather_idx, device=ref.device), q, kind="+")
    return qm_adjust_core(sim, hist_q, af, device_brackets(gi, "linear", ref.device), kind="+", interp="linear", extrapolation="constant", tables_compact=True)


def mbcn_problem(n_sites):
    """``bench.py``'s MBCn data (``bench.py:221-238``): [site, multivar,
    time] f32 ~ N(10, 3) over 30 noleap years, ref from numpy seed 1, hist
    from seed 2 (and sim from seed 3, thirty years on), as numpy-backed
    DataArrays."""
    T = 365 * MBCN_YEARS
    mv = np.array(["tasmax", "pr", "huss"])

    def mk(seed, start):
        t = xp.date_range(start, periods=T, freq="D", calendar="noleap")
        x = np.random.default_rng(seed).normal(10, 3, (n_sites, MBCN_VARS, T)).astype(np.float32)
        return xp.DataArray(x, ("site", "multivar", "time"), {"time": t, "multivar": mv, "site": np.arange(n_sites)}, {"units": ""}, "data")

    return mk(1, "1981-01-01"), mk(2, "1981-01-01"), mk(3, "2011-01-01")


def run_mbcn(ref, hist, sim, group, nq, rot=None, base_kws_vars=None):
    """The public MBCn path: train, then adjust.  Returns (trained, scen)."""
    obj = xp.MBCn.train(ref, hist, base_kws={"nquantiles": nq, "group": xp.Grouper(*group)}, n_iter=MBCN_ITERS, n_escore=-1, rot_matrices=rot)
    return obj, obj.adjust(sim, ref, hist, base_kws_vars=base_kws_vars)


def mbcn_chunks(n_sites, group):
    """(chunks of group blocks, blocks, block width, blocks a chunk) of an
    MBCn call."""
    G, Lw = xp.Grouper(*group).indexes(xp.date_range("1981-01-01", periods=365 * MBCN_YEARS, freq="D", calendar="noleap")).gather_idx.shape
    chunk = mbcn._chunk_size(G, n_sites * MBCN_VARS, Lw)
    return -(-G // chunk), G, Lw, chunk


def pr_problem(n_sites, n_years, seeds=(4, 5)):
    """Config 2's data: daily pr, f32, mm/d, over ``n_years`` noleap years
    from 1950: ref 60 % wet days of Gamma(0.9, scale 5) and hist 80 % wet
    days of Gamma(0.7, scale 5) (the drizzle bias), drawn in turn from numpy
    seed ``seeds[0]`` (4); sim hist's recipe from ``seeds[1]`` (5), times a
    trend of 1 + 0.3 t / T."""
    T = 365 * n_years
    t = xp.date_range("1950-01-01", periods=T, freq="D", calendar="noleap")

    def wet(rng, share, k):
        return (rng.gamma(k, 5.0, (n_sites, T)) * (rng.random((n_sites, T)) < share)).astype(np.float32)

    rng = np.random.default_rng(seeds[0])
    ref, hist = wet(rng, 0.6, 0.9), wet(rng, 0.8, 0.7)
    sim = wet(np.random.default_rng(seeds[1]), 0.8, 0.7) * (1 + 0.3 * np.arange(T, dtype=np.float32) / T)
    return t, (ref, hist, sim)


def _pr_da(x, t, name):
    return xp.DataArray(x, ("site", "time"), {"time": t}, {"units": "mm/d"}, name)


def config2_train(ref, hist, t):
    return xp.DetrendedQuantileMapping.train(_pr_da(ref, t, "ref"), _pr_da(hist, t, "hist"), **PR_TRAIN)


def config2_adjust(dqm, sim, t):
    """Config 2's adjust: nearest, LOESS detrending on the whole series (the
    FFT core); a Dataset with ``scen`` and ``trend``."""
    with xp.set_options(extra_output=True):
        return dqm.adjust(_pr_da(sim, t, "sim"), interp="nearest", detrend=xp.detrending.LoessDetrend(group="time", kind="*", **LOESS_KW))


def extremes_run(ref, hist, sim, scen, t):
    """``ExtremeValues.train(ref, hist).adjust(sim, scen)`` through the public
    calls on config 2's pr: (trained, second-order scen)."""
    ev = xp.ExtremeValues.train(_pr_da(ref, t, "ref"), _pr_da(hist, t, "hist"), **EV_TRAIN)
    return ev, ev.adjust(_pr_da(sim, t, "sim"), _pr_da(scen, t, "scen"), **EV_ADJUST)


def pca_run(ref, hist, sim, orientation):
    """``PrincipalComponents`` over ``multivar``, monthly: (trained, scen)."""
    pca = xp.PrincipalComponents.train(ref, hist, crd_dim="multivar", group="time.month", best_orientation=orientation)
    return pca, pca.adjust(sim)


def ot_problem(n_years=OT_YEARS):
    """One site's tas (K) and pr (mm/d) drawn as the e2e cases draw them
    (``tests/e2e_cases.py``: tas ~ N(mean, 1), pr ~ Gamma(2, 2)) over
    ``n_years`` noleap years from numpy seed 6: (ref, hist, sim) stacked
    over ``multivar``, numpy-backed."""
    T = 365 * n_years
    rng = np.random.default_rng(6)

    def stacked(mean, start):
        t = xp.date_range(start, periods=T, freq="D", calendar="noleap")
        return xp.processing.stack_variables(xp.Dataset({
            "tas": xp.DataArray(rng.normal(mean, 1, T), ("time",), {"time": t}, {"units": "K"}, "tas"),
            "pr": xp.DataArray(rng.gamma(2, 2, T), ("time",), {"time": t}, {"units": "mm/d"}, "pr"),
        }))

    return stacked(0.0, "1981-01-01"), stacked(1.0, "1981-01-01"), stacked(1.5, "2041-01-01")


# the transports phase 5e runs: (class, keywords); bin widths estimated
OT_RUNS = {
    "OTC": (xp.OTC, dict(group="time.month", solver="emd")),
    "dOTC": (xp.dOTC, dict(group="time.month", solver="emd")),
    "dOTC kind pr *": (xp.dOTC, dict(group="time.month", solver="emd", kind={"pr": "*"}, cov_factor="std")),
}


def ot_run(name, ref, hist, sim, **extra):
    """One transport of :data:`OT_RUNS` through the public call, drawing
    from the stream seeded with ``OT_SEED``."""
    cls, kw = OT_RUNS[name]
    xp.utils.rng.seed(OT_SEED)
    return cls.adjust(*((ref, hist) if cls is xp.OTC else (ref, hist, sim)), **{**kw, **extra})


def occupied_bins(ref, hist, group="time.month"):
    """Occupied histogram bins a group of hist and of ref, at the bin widths
    OTC estimates for that group."""
    g = xp.Grouper(group)
    blocks = [otc._grouped_PV(otc._host(d, "multivar"), g.indexes(d.time)) for d in (hist, ref)]
    out = []
    for X, Y in zip(*blocks):
        X, Y = X[np.isfinite(X).all(axis=1)], Y[np.isfinite(Y).all(axis=1)]
        width, origin = otc._BinSpec(None, None).resolve([Y, X])
        out.append(tuple(len(otc._support(P, width, origin).weights) for P in (X, Y)))
    return out


def dqm_doy_train(ref, hist, t):
    return xp.DetrendedQuantileMapping.train(_da(ref, t, "ref"), _da(hist, t, "hist"), kind="+", group="time.dayofyear", window=HEAVY_WINDOW, nquantiles=NQ)


def dqm_doy_adjust(dqm, sim, t):
    """The windowed DQM's adjust: nearest, a degree-1 polynomial trend a
    windowed dayofyear group."""
    with xp.set_options(extra_output=True):
        return dqm.adjust(_da(sim, t, "sim"), detrend=1)


def config5_block(b, n_sites=C5_BLOCK, n_years=C5_YEARS):
    """Block ``b`` of config 5's tile: (time, tas, pr), each a tuple of numpy
    f32 [n_sites, T] (ref, hist, sim) over ``n_years`` noleap years from
    1950.  tas (K) is the headline recipe from numpy seed C5_SEED + b plus a
    seasonal cycle of 8 K amplitude, sim warmed by 2 K over the period (so
    that the trend and the annual cycle's phase do not measure ties); pr
    (mm/d) is config 2's recipe from seeds C5_SEED + 10 + b and C5_SEED + 20
    + b."""
    t, tas = example_problem(n_sites, n_years, seed=C5_SEED + b, start="1950-01-01")
    T = len(t)
    cycle = (8 * np.sin(2 * np.pi * (np.arange(T) - 105) / 365)).astype(np.float32)
    tas = [a + cycle for a in tas]
    tas[2] += (2.0 * np.arange(T) / T).astype(np.float32)
    _, pr = pr_problem(n_sites, n_years, seeds=(C5_SEED + 10 + b, C5_SEED + 20 + b))
    return t, tuple(tas), pr


def config5_coords(b, n_sites=C5_BLOCK):
    """The ``lat`` / ``lon`` of block ``b``'s sites: the tile's points in
    row-major order (lat outer), 0.25 degrees apart."""
    i = np.arange(b * n_sites, (b + 1) * n_sites)
    return {"lat": 40.125 + 0.25 * (i // C5_LON), "lon": 0.125 + 0.25 * (i % C5_LON)}


def config5_qdm(mod, t, tas, pr, coords=None):
    """Config 5's adjustment through ``mod``'s public calls (the port, or a
    package with its API): QDM train + adjust of tas (additive) and pr
    (multiplicative, with the jitter its users pass: ROADMAP C17), monthly,
    nq 50.  ``tas`` / ``pr``: (ref, hist, sim) arrays or tensors.  Returns
    ({"ref", "hist", "sim", "scen"}: DataArray) for tas and for pr."""
    out = []
    for x, units, name, kw in ((tas, "K", "tas", dict(kind="+")), (pr, "mm/d", "pr", dict(kind="*", jitter_under_thresh_value="0.01 mm/d"))):
        das = {k: mod.DataArray(a, ("site", "time"), {"time": t, **(coords or {})}, {"units": units}, name) for k, a in zip(("ref", "hist", "sim"), x)}
        qdm = mod.QuantileDeltaMapping.train(das["ref"], das["hist"], group="time.month", nquantiles=NQ, **kw)
        das["scen"] = qdm.adjust(das["sim"], interp="linear")
        out.append(das)
    return tuple(out)


def config5_suite(props, meas, tas, pr):
    """Config 5's validation suite through ``props`` / ``meas`` (the port's
    ``properties`` and ``measures``, or a package's with their API) on ref,
    sim and scen of tas and pr, and its measures of scen against ref:
    {label: DataArray}; the return values are :func:`config5_return_values`."""
    out = {}
    for k in ("ref", "sim", "scen"):
        t, p = tas[k], pr[k]
        out[f"{k} mean"] = props.mean(t)
        out[f"{k} std"] = props.std(t)
        out[f"{k} q98"] = props.quantile(t, q=0.98)
        out[f"{k} trend"] = props.trend(t)
        out[f"{k} amplitude"] = props.annual_cycle_amplitude(t)
        out[f"{k} phase"] = props.annual_cycle_phase(t)
        out[f"{k} spell"] = props.spell_length_distribution(p, thresh="1 mm/d")
        out[f"{k} spell monthly"] = props.spell_length_distribution(p, thresh="1 mm/d", group="time.month")
        out[f"{k} wet freq"] = props.relative_frequency(p, thresh="1 mm/d")
        out[f"{k} wet-wet"] = props.transition_probability(p, thresh="1 mm/d")
        out[f"{k} pr q98"] = props.quantile(p, q=0.98)
        out[f"{k} corr"] = props.corr_btw_var(t, p)
    for name in ("mean", "std", "q98", "trend", "amplitude", "spell", "pr q98"):
        out[f"bias {name}"] = meas.bias(out[f"scen {name}"], out[f"ref {name}"])
    out["relative_bias wet freq"] = meas.relative_bias(out["scen wet freq"], out["ref wet freq"])
    out["circular_bias phase"] = meas.circular_bias(out["scen phase"], out["ref phase"])
    for name in ("rmse", "mae", "annual_cycle_correlation"):
        out[name] = getattr(meas, name)(tas["scen"], tas["ref"])
    return out


def config5_return_values(props, meas, tas):
    """The suite's 20-year return values of tas (a GEV fit by maximum
    likelihood on the annual maxima) of ref, sim and scen, and the bias of
    scen's against ref's: {label: DataArray}."""
    out = {f"{k} rv20": props.return_value(tas[k], period=20, method="ML") for k in ("ref", "sim", "scen")}
    out["bias rv20"] = meas.bias(out["scen rv20"], out["ref rv20"])
    return out


class SeededDraws:
    """While active, the port's preprocessing draws (jitter, adapt_freq) are
    made on the CPU, each from a generator seeded anew (``seed``, ``seed + 1``,
    ...), and moved to the data's device.  A run on the card and a run on the
    CPU of its first sites then draw the same numbers for those sites; the
    stream's own generators differ between devices."""

    def __init__(self, seed):
        self.seed = seed

    def __enter__(self):
        self.saved, count = processing._uniform, iter(range(self.seed, self.seed + (1 << 30)))

        def uniform(x, low, high):
            u = torch.rand(tuple(x.shape), dtype=x.dtype, generator=torch.Generator().manual_seed(next(count)))
            return torch.clamp(u * (high - low) + low, min=low).to(x.device)

        processing._uniform = uniform
        return self

    def __exit__(self, *exc):
        processing._uniform = self.saved


def held_with_flips(label, got, want):
    """The card's ``got`` against the CPU port's ``want`` where a nearest
    lookup may pick a neighbouring node: values off by more than FLIP_RTOL
    are counted as rank flips (at most MAX_FLIPS of the values); the rest
    must be within FLIP_RTOL.  Returns the line to print."""
    torch.testing.assert_close(torch.isnan(got), torch.isnan(want))
    ok = _nan_equal(got, want) | ((got - want).abs() <= FLIP_RTOL * want.abs() + FLIP_RTOL)
    flips = int((~ok).sum())
    near = torch.where(ok, got, want)
    err = _max_abs(near, want)
    share = flips / got.numel()
    assert share <= MAX_FLIPS, f"{label}: {flips} of {got.numel()} values moved by a node step"
    return f"{flips} of {got.numel()} values moved by a node step (rank flips), the rest within {FLIP_RTOL:g} (max abs diff {err:.3g})"


def first_sites(da, n):
    return xp.DataArray(da.data[:n], da.dims, {**da.coords, "site": np.arange(n)}, dict(da.attrs), da.name)


def univariate_blocks(ref, hist, sim, group, nq, n):
    """The per-block univariate QDM output of the first ``n`` sites, on the
    card: [V, n, G, Lw] (what MBCn's adjust reorders), and sim's group
    indexes."""
    gi, gi_sim = (xp.Grouper(*group).indexes(d.coords["time"]) for d in (ref, sim))
    dev = torch.device("cuda", 0)
    rows_ref, rows_sim = (torch.as_tensor(g.gather_idx, device=dev) for g in (gi, gi_sim))
    kws, adj = {"nquantiles": nq}, {"interp": "nearest", "extrapolation": "constant"}
    lay = lambda d: torch.from_numpy(np.moveaxis(d.data[:n], 1, 0).copy()).to(dev)   # noqa: E731  [V, n, T]
    r, h, s = lay(ref), lay(hist), lay(sim)
    return torch.stack([mbcn._per_block_univariate(r[iv], h[iv], s[iv], rows_ref, rows_sim, kws, adj) for iv in range(MBCN_VARS)]), gi_sim


def check_mbcn(tag, cfg, ref, hist, sim, obj, scen, counts):
    """The gates of an MBCn run on the card (see the module docstring, 5c);
    returns the line to print."""
    S, group, nq, n = cfg["sites"], cfg["group"], cfg["nq"], cfg["check"]
    T = 365 * MBCN_YEARS
    n_chunks, G, Lw, _ = mbcn_chunks(S, group)
    data = scen.data
    assert data.is_cuda and data.dtype == torch.float32 and tuple(data.shape) == (S, MBCN_VARS, T), (data.device, data.dtype, tuple(data.shape))
    assert bool(torch.isfinite(data).all()) and bool(torch.isfinite(obj.ds["af_q"].data).all()), f"{tag}: non-finite output"
    want_2d = n_chunks * (MBCN_ITERS + MBCN_ITERS + MBCN_VARS)   # train: n_iter a chunk; adjust: n_iter + V a chunk
    assert counts["interp_table_2d"] == want_2d, f"{tag}: K2 launched {counts['interp_table_2d']} times, {want_2d} expected"
    assert counts["fma"] >= 1, f"{tag}: launches {counts}"
    others = [k for k in counts if k not in ("interp_table_2d", "fma") and counts[k]]
    assert not others, f"{tag}: another kernel of the port ran: {counts}"
    # every scen value is one of its block's univariate QDM values, exactly
    blocks, gi_sim = univariate_blocks(ref, hist, sim, group, nq, n)                  # [V, n, G, Lw]
    got = data[:n].movedim(1, 0)                                                       # [V, n, T]
    if G == 1:
        uni = blocks[:, :, 0, :]
        assert torch.equal(torch.sort(got, dim=-1).values, torch.sort(uni, dim=-1).values), f"{tag}: scen is not a permutation of the univariate QDM series"
        moved = float((got != uni).float().mean())
    else:
        ordered = torch.sort(torch.nan_to_num(blocks, nan=float("inf")), dim=-1).values
        mine = ordered[:, :, torch.as_tensor(gi_sim.group_idx, device=data.device).long(), :]   # [V, n, T, Lw]
        at = torch.searchsorted(mine, got[..., None].contiguous()).clamp_(max=Lw - 1)
        assert bool((torch.gather(mine, -1, at)[..., 0] == got).all()), f"{tag}: a scen value is not among its block's univariate QDM values"
        centre = blocks[:, :, torch.as_tensor(gi_sim.group_idx, device=data.device).long(), torch.as_tensor(gi_sim.scatter_slot, device=data.device).long()]
        moved = float((got != centre).float().mean())
        del ordered, mine, at, centre
    # the port's CPU path on the first sites, the card's rotations injected
    rot = obj.ds["rot_matrices"].data.cpu()
    with xp.set_options(device="cpu"):
        cpu_obj, cpu_scen = run_mbcn(*(first_sites(d, n) for d in (ref, hist, sim)), group, nq, rot=rot)
    d_af = (obj.ds["af_q"].data[:n].cpu() - cpu_obj.ds["af_q"].data).abs().amax(dim=(-1, -2))     # [n, G, I]
    assert float(d_af[..., 0].max()) <= MBCN_AF_TOL, f"{tag}: af_q differs from the CPU port by {float(d_af[..., 0].max()):.3g} in the first iteration"
    early = float((d_af[..., :MBCN_FIRST] <= MBCN_AF_TOL).all(dim=-1).float().mean())
    assert early >= 0.5, f"{tag}: only {100 * early:.1f} % of the trajectories stay within {MBCN_AF_TOL:g} of the CPU port over the first {MBCN_FIRST} iterations"
    scale = float(cpu_obj.ds["af_q"].data.abs().max())
    assert float(d_af.max()) <= scale, f"{tag}: af_q differs from the CPU port by {float(d_af.max()):.3g}, more than the factors' own size {scale:.3g}"
    together = float((d_af <= MBCN_AF_TOL).all(dim=-1).float().mean())
    by_iter = [float(x) for x in d_af.amax(dim=(0, 1))]
    same = float((data[:n].cpu() == cpu_scen.data).float().mean())
    if G == 1:
        assert torch.equal(torch.sort(data[:n].cpu(), dim=-1).values, torch.sort(cpu_scen.data, dim=-1).values), f"{tag}: scen's values differ from the CPU port's"
    return (f"finite, launches {counts} (K2: {n_chunks} chunk(s) x (2 x {MBCN_ITERS} + {MBCN_VARS})); first {n} sites vs the CPU port with the same rotations: "
            f"af_q max abs diff {float(d_af[..., 0].max()):.3g} in the first iteration, {100 * early:.1f} % of the trajectories within {MBCN_AF_TOL:g} over the first "
            f"{MBCN_FIRST}, {float(d_af.max()):.3g} over all {MBCN_ITERS} "
            f"(factors up to {scale:.3g}; by iteration {' '.join(f'{x:.1e}' for x in by_iter)}); "
            f"{100 * together:.1f} % of {d_af.shape[0] * d_af.shape[1]} (site, block) trajectories within {MBCN_AF_TOL:g} throughout; scen: every value one of its block's "
            f"univariate QDM values ({100 * moved:.1f} % of the positions reordered), {100 * same:.2f} % of the positions equal to the CPU port's")


def nan_masked(arrays, seed=2):
    """Copies of [site, time] arrays with sites 0-1 all NaN and 10 % of the
    values of sites 2-5 NaN (the dynamic-count case)."""
    rng = np.random.default_rng(seed)
    out = []
    for a in arrays:
        a = a.copy()
        a[:2] = np.nan
        a[2:6][rng.random(a[2:6].shape) < 0.1] = np.nan
        out.append(a)
    return out


def sort_inputs(B, T, seed=0, device="cpu"):
    """Keys [B, T] f32 with ties, +-0.0 and +inf, and int32 payloads."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T)).astype(np.float32)
    x[:, ::7] = 1.5
    x[:, 1::11] = 0.0
    x[:, 2::13] = -0.0
    x[:, 3::17] = np.inf
    lab = rng.integers(0, 1 << 20, (B, T)).astype(np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(lab).to(device)


def widened(slab, width):
    """The slab [B, Dp, m] with each row cut to ``width`` values, or padded
    with +inf to ``width``."""
    if width <= slab.shape[-1]:
        return slab[..., :width].contiguous()
    pad = torch.full(slab.shape[:-1] + (width - slab.shape[-1],), torch.inf, dtype=slab.dtype, device=slab.device)
    return torch.cat([slab, pad], dim=-1)


def selection_stage1(ref, hist, plan):
    """The selection step's stage-1 input for [site, time] ref and hist:
    keys [2 * sites, T] (NaN as +inf) and packed labels (0 under NaN)."""
    x = torch.stack([ref, hist]).reshape(-1, ref.shape[-1])
    lab = plan_labels(plan, x.device).expand(x.shape)
    bad = torch.isnan(x)
    return torch.where(bad, torch.inf, x), torch.where(bad, 0, lab)


def pair_sorted(keys, lab):
    """(key, payload) pairs of each row in lexicographic order."""
    order = torch.argsort(lab, dim=1, stable=True)
    keys, lab = torch.gather(keys, 1, order), torch.gather(lab, 1, order)
    order = torch.argsort(keys, dim=1, stable=True)
    return torch.gather(keys, 1, order), torch.gather(lab, 1, order)


def _nan_equal(a, b):
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _max_abs(a, b):
    d = torch.where(_nan_equal(a, b), torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def _compare(label, got, want):
    """Print and return (values differing under ==, max abs diff)."""
    torch.cuda.synchronize()
    n_diff = int((~_nan_equal(got, want)).sum())
    err = _max_abs(got, want)
    print(f"[kernel] {label} {tuple(got.shape)}: {n_diff} of {got.numel()} values differ from the twin (max abs diff {err:.3g})", flush=True)
    assert n_diff == 0, f"{label}: kernel and twin disagree"
    return err


def _compare_bits(label, got, want):
    """Print and return (values differing by bit pattern, any NaN equal to
    any NaN, max abs diff)."""
    torch.cuda.synchronize()
    both_nan = torch.isnan(got) & torch.isnan(want)
    n_diff = int(((_bits(got) != _bits(want)) & ~both_nan).sum())
    err = _max_abs(got, want)
    print(f"[kernel] {label} {tuple(got.shape)}: {n_diff} of {got.numel()} values differ from the twin by bit pattern "
          f"(max abs diff {err:.3g})", flush=True)
    assert n_diff == 0, f"{label}: kernel and twin disagree"
    return err


def _hold_fma(err, label, *args):
    """``fma`` against its emulation by bit pattern, its layout's path named."""
    lay = fma_kernel.layout(*args)
    label = f"fma {label} [{lay.path}, {lay.shape}, dense {lay.dense}]"
    err["fma"] = max(err.get("fma", 0.0), _compare_bits(label, fma_kernel.fma(*args), fma_kernel.fma_reference(*args)))
    return lay.path


def _hold(err, key, label, kernel, twin, *args):
    """``kernel(*args)`` against ``twin(*args)`` (:func:`_compare`), the
    largest difference so far kept under ``err[key]``."""
    err[key] = max(err.get(key, 0.0), _compare(label, kernel(*args), twin(*args)))


def _hold_bits(err, key, label, kernel, twin, *args):
    """``kernel(*args)`` against ``twin(*args)`` by bit pattern
    (:func:`_compare_bits`), the largest difference so far kept under
    ``err[key]``."""
    err[key] = max(err.get(key, 0.0), _compare_bits(label, kernel(*args), twin(*args)))


def zero_tie_rows(B, T, seed=0, every=7):
    """[B, T] f32 rows half +0.0 and half -0.0 in random order, every
    ``every``-th value N(0, 1), 1 % NaN: the value sorts' ±0.0 ties (ROADMAP
    C29), which a sort keeps in their input order only if it is stable."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((B, T)) < 0.5, 0.0, -0.0).astype(np.float32)
    x[:, ::every] = rng.normal(0, 1, x[:, ::every].shape)
    x[rng.random((B, T)) < 0.01] = np.nan
    return x


def dry_day_problem(n_sites, n_years, seed=14):
    """The headline shape with pr-like data: gamma values, 30 % (ref) and 45 %
    (hist, sim) of the days ±0.0 in random order, so that quantiles, ranks
    and (``kind="*"``) factors meet the sorts' ±0.0 ties."""
    t = xp.date_range("2000-01-01", periods=365 * n_years, freq="D", calendar="noleap")
    rng = np.random.default_rng(seed)
    data = []
    for frac in (0.3, 0.45, 0.45):
        x = rng.gamma(2.0, 2.0, (n_sites, len(t))).astype(np.float32)
        dry = rng.random(x.shape) < frac
        x[dry] = np.where(rng.random(int(dry.sum())) < 0.5, 0.0, -0.0)
        data.append(x)
    return t, data


def _unstable_nan_quantile(x, quantiles, axis=-1, alpha=1.0, beta=1.0, fused=True):
    """``ops/quantile.py:nan_quantile`` as it was before ROADMAP C29's repair
    (an unstable ``torch.sort``), bound in its place to time the headline
    step before the repair."""
    from xsdba_tpu_torch.ops import quantile as quant

    x = torch.movedim(quant.as_tensor(x), axis, -1)
    q = quant.as_tensor(quantiles, dtype=x.dtype, device=x.device)
    return quant._quantile_on_sorted(torch.sort(x, dim=-1).values, (~torch.isnan(x)).sum(dim=-1), q, alpha, beta, fused=fused)


def merge_tie_slabs(n_sites, n_years, device):
    """The merge engine's unsorted slabs of :func:`dry_day_problem`'s ref and
    hist (30 % and 45 % of the days ±0.0), as the heavy path builds them:
    {window: (slab [2 * n_sites, Dp, 256] f32, groups, ymax, levels)} at
    windows 31 and 5."""
    t, (ref, hist, _) = dry_day_problem(n_sites, n_years)
    x = torch.from_numpy(np.stack([ref, hist])).to(device)
    out = {}
    for window in (HEAVY_WINDOW, SMALL_WINDOW):
        plan = xp.Grouper("time.dayofyear", window=window).indexes(t).merge_plan
        slab, _, L = merge_slab(x, plan)
        out[window] = (slab, plan.w1_gather.shape[0] - 2 * plan.half, plan.w1_gather.shape[1], L)
    return out


def build_merge_library(label, spec):
    """The merge kernels of another source, bound as ``ops/merge.py`` binds
    its own: ``spec`` is ``SOURCE[,NVCC_FLAG...]``, a ``merge_kernel.cu``
    (its headers beside it) built with the port's nvcc flags and the extra
    ones into the build directory."""
    source, *flags = spec.split(",")
    lib = _build._build_dir() / f"libxsdba_merge_against_{re.sub(r'[^A-Za-z0-9_]', '_', label)}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(Path(source).resolve())], check=True)
    out = ctypes.CDLL(str(lib))
    for fn, (args, res) in merge._SIGNATURES.items():
        getattr(out, fn).argtypes = args
        getattr(out, fn).restype = res
    return out


def _merge_through(lib, fn):
    """``fn`` with ``ops/merge.py``'s wrappers launching ``lib``'s kernels."""
    def run():
        own = merge._library
        merge._library = lambda: lib
        try:
            return fn()
        finally:
            merge._library = own
    return run


def merge_tie_diffs(tie_slabs, f64_rows=64):
    """Values of each merge kernel on :func:`merge_tie_slabs` that differ from
    its twin's by bit pattern (ROADMAP C32: the twins order ±0.0 by IEEE
    totalOrder, as the reference's Pallas kernels do): K3 (the warp sort in
    f32 and, on the first ``f64_rows`` rows, f64; the long-row variant at
    2048 values), K5 and K6 at window 31, K4 at window 5, each kernel fed
    its twin's input."""
    out = {"K3": 0, "K4": 0, "K5": 0, "K6": 0}
    n_diff = lambda a, b: int((_bits(a) != _bits(b)).sum())  # noqa: E731
    for window, (slab, G, ymax, L) in tie_slabs.items():
        for rows in (slab, slab[:f64_rows].double().contiguous()):
            for width in (rows.shape[-1], 2048):
                x = widened(rows[:f64_rows], width) if width != rows.shape[-1] else rows
                out["K3"] += n_diff(merge.sort_rows_alternating(x), merge.sort_rows_alternating_reference(x))
            ordered = merge.sort_rows_alternating_reference(rows)
            if L:
                levels = merge.build_levels_reference(ordered, L)
                out["K5"] += n_diff(merge.build_levels(ordered, L), levels)
                got = merge.fold_windows(ordered, levels, window, G, ymax=ymax)
                out["K6"] += n_diff(got, merge.fold_windows_reference(ordered, levels, window, G, got.shape[-1]))
            else:
                got = merge.merged_window_rows(ordered, window, G, ymax=ymax)
                out["K4"] += n_diff(got, merge.merged_window_rows_reference(ordered, window, G, got.shape[-1]))
    torch.cuda.synchronize()
    return out


def merge_against(smi, others, slab, L, G, ymax, ordered5):
    """Each build of ``others`` ({label: spec}, :func:`build_merge_library`)
    against this checkout's merge kernels: the kernels timed in turns at the
    heavy path's shapes (K3 on its slab in f32 and f64, K5 and K6 at window
    31, K4 at window 5: 7 rounds, the order reversed every other round, a
    sample the mean of 10 calls queued behind a spin of the card), each
    build's values on :func:`merge_tie_slabs` that differ from the twins by
    bit pattern, and phase 4e's public dry-day ``kind="*"`` QDM train
    (:func:`c31_phase`) through each build, its first CHECK_SITES sites'
    factors against the CPU port's by bit pattern.  Prints each and returns
    {label: {...}}."""
    builds = {"this": merge._library()}
    for label, spec in others.items():
        builds[label] = build_merge_library(label, spec)
        print(f"[merge-against] built {label} from {spec}", flush=True)
    slab64 = slab.double()
    ordered = merge.sort_rows_alternating(slab)
    levels = merge.build_levels(ordered, L)
    calls = {
        "K3 f32": lambda: merge.sort_rows_alternating(slab),
        "K3 f64": lambda: merge.sort_rows_alternating(slab64),
        "K5": lambda: merge.build_levels(ordered, L),
        "K6": lambda: merge.fold_windows(ordered, levels, HEAVY_WINDOW, G, ymax=ymax),
        "K4": lambda: merge.merged_window_rows(ordered5, SMALL_WINDOW, G, ymax=ymax),
    }
    shapes = {"K3 f32": tuple(slab.shape), "K3 f64": tuple(slab.shape), "K5": f"{tuple(ordered.shape)} L={L}",
              "K6": f"{tuple(ordered.shape)} w={HEAVY_WINDOW}", "K4": f"{tuple(ordered5.shape)} w={SMALL_WINDOW}"}
    res = {label: {} for label in builds}
    for k, fn in calls.items():
        turns = _steps_in_turns({label: _merge_through(lib, fn) for label, lib in builds.items()}, reps=7, batch=KERNEL_BATCH)
        for label, sm in turns.items():
            res[label][k] = {"median_ms": sm["median_ms"], "spread": sm["spread"]}
        print(f"[merge-against] {k} {shapes[k]} in turns: " + "; ".join(
            f"{label} {_fmt(sm)} ({sm['median_ms'] / turns['this']['median_ms']:.3f} of this)" for label, sm in turns.items()) + f" [{smi}]", flush=True)
    del slab64, ordered, levels
    t, (ref_np, hist_np, _) = dry_day_problem(N_SITES, N_YEARS)
    group = xp.Grouper("time.dayofyear", window=HEAVY_WINDOW)
    train = lambda r, h: xp.QuantileDeltaMapping.train(_pr_da(r, t, "ref"), _pr_da(h, t, "hist"), kind="*", group=group, nquantiles=NQ)  # noqa: E731
    with xp.set_options(device="cpu", selection_backend=False):
        want = train(ref_np[:CHECK_SITES], hist_np[:CHECK_SITES]).ds["af"].data
    tie_slabs = merge_tie_slabs(HEAVY_SITES, HEAVY_YEARS, slab.device)
    for label, lib in builds.items():
        res[label]["tie values differing from the twins"] = _merge_through(lib, lambda: merge_tie_diffs(tie_slabs))()
        af = _merge_through(lib, lambda: train(ref_np, hist_np).ds["af"].data[:CHECK_SITES].cpu())()
        moved = (_bits(af) != _bits(want)) & ~(torch.isnan(af) & torch.isnan(want))
        res[label]["C32 factors"] = {"differ": int(moved.sum()), "of": af.numel(),
                                     "infinities of the other sign": int((moved & torch.isinf(af) & (af == -want)).sum())}
        print(f"[merge-against] {label}: merge-kernel values on ±0.0 tie slabs differing from the twins by bit pattern "
              f"{res[label]['tie values differing from the twins']}; public dry-day kind=* dayofyear+{HEAVY_WINDOW} QDM, "
              f"first {CHECK_SITES} sites' trained factors vs the CPU port: {res[label]['C32 factors']}", flush=True)
    print(f"[merge-against] {json.dumps(res)}", flush=True)
    return res


def _compare_sort(label, key, lab):
    """K7 against its twin: keys under ``==`` and the pair multisets."""
    got_k, got_l = sort.sort_rows_with_payload(key, lab)
    want_k, want_l = sort.sort_rows_with_payload_reference(key, lab)
    torch.cuda.synchronize()
    n_diff = int((got_k != want_k).sum())
    gk, gl = pair_sorted(got_k, got_l)
    wk, wl = pair_sorted(want_k, want_l)
    same = bool((gk == wk).all() and (gl == wl).all())
    print(f"[kernel] K7 {label} {tuple(key.shape)} -> {tuple(got_k.shape)}: {n_diff} keys differ from the twin under ==; "
          f"(key, payload) multisets {'equal' if same else 'DIFFER'}", flush=True)
    assert n_diff == 0 and same, f"K7 {label}: kernel and twin disagree"
    return 0.0


def wet_day_rows(B, T, seed=3):
    """Precipitation-like rows [B, T] float64: 70 % of the days exactly
    zero, +0.0 or -0.0 at random, the rest gamma(0.6, 4): the zeros tie, so
    a group's ranks crowd into one chunk of the sorted row."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.6, 4.0, (B, T))
    dry = rng.random((B, T)) < 0.7
    x[dry] = np.where(rng.random(int(dry.sum())) < 0.5, 0.0, -0.0)
    return x


def emit_operands(x, plan):
    """The emission's operands for rows ``x`` [B, T] on the card under
    ``plan``: stages 1 and 2a as the selection path runs them (K7 for
    float32, ``torch.sort`` for float64), nq = NQ."""
    q = equally_spaced_nodes(NQ)
    G = int(plan.fast_mask.shape[0])
    return _emit_operands(x, plan_labels(plan, x.device), q, G=G, sort_impl=default_sort_impl(x.dtype, x.device))


def emit_edge_operands(B, T, G, window, dtype, seed=0, device="cpu", nb_chunk=128):
    """The emission's operands on synthetic labels: T values a row on a
    cycle of G groups, each value a member of the window of groups centred
    on its own (intervals of min(window, G) groups from (t - window // 2)
    mod G, so some wrap past G - 1; with G groups or more a value is in
    every group), a seventh of the values +-0.0; row 0 all NaN, row 1 NaN
    on group G - 1's own values (with window 1 that group has no valid
    value), row 2 15 % NaN.  Stages 1 and 2a as the selection path runs
    them, nq = NQ, chunks of nb_chunk blocks of 64."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T))
    x[:, ::7] = np.where(rng.random(x[:, ::7].shape) < 0.5, 0.0, -0.0)
    day = np.arange(T) % G
    lab = (((day - window // 2) % G) * 1024 + min(window, G)).astype(np.int32)
    x[0] = np.nan
    if B > 1:
        x[1, day == G - 1] = np.nan
    if B > 2:
        x[2, rng.random(T) < 0.15] = np.nan
    t = torch.from_numpy(x).to(device, dtype)
    return _emit_operands(t, torch.from_numpy(lab).to(device), equally_spaced_nodes(NQ), G=G, nb_chunk=nb_chunk,
                          sort_impl=default_sort_impl(dtype, t.device))


def emit_overflows(ops, slots):
    """Whether some chunk of ``ops`` needs more than ``slots`` ranks of a
    group, so that the twin reruns its emission at nq slots."""
    svals, slab, clo, r_left, r_right, n, chunk = ops
    chi = torch.cat([clo[:, 1:], n[:, None]], dim=1)
    return any(int(emit_kernel._windows(rk, clo, chi)[1].max()) > slots for rk in (r_left, r_right))


def _bits(a):
    return a.view(torch.int32 if a.dtype == torch.float32 else torch.int64)


def _compare_emit(label, ops, slots=32):
    """The emission kernel against its twin (``slots`` for the twin): left,
    right and the max, by bit pattern."""
    got = emit_kernel.emit(*ops, slots=slots)
    want = emit_kernel.emit_reference(*ops, slots=slots)
    torch.cuda.synchronize()
    n_diff = [int((_bits(g) != _bits(w)).sum()) for g, w in zip(got, want)]
    print(f"[kernel] emit {label} {tuple(ops[0].shape)}, chunk {ops[-1]}: {n_diff} values of (left, right, max) differ from the twin "
          "by bit pattern", flush=True)
    assert not any(n_diff), f"emit {label}: kernel and twin disagree"
    return max(_max_abs(g, w) for g, w in zip(got, want))


def _bound(n_bytes, n_ops):
    """Least time (ms) on an H100 for the bytes moved and the operations
    done, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, warmup=2, reps=5, batch=1):
    """CUDA-event times (ms) of ``reps`` calls after ``warmup`` calls.  With
    ``batch`` > 1 a sample is the mean of that many back-to-back calls
    queued behind a spin of the card (``SPIN_CYCLES``), so that the host's
    cost of launching them stays out of it: the device time of a kernel."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if batch > 1:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / batch)
    return out


def _host_ms(fn, warmup=2, reps=5, cached=False):
    """Host-clock times (ms) of ``reps`` synchronised calls after ``warmup``.
    Unless ``cached``, the device-copy cache is emptied before each call
    (outside the time), so that a public call uploads its numpy inputs as
    it did before the cache, and its time compares with earlier runs."""
    out = []
    for i in range(warmup + reps):
        if not cached:
            _wrap.clear_device_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def _summary(ms):
    med = statistics.median(ms)
    return {"median_ms": med, "min_ms": min(ms), "max_ms": max(ms), "spread": (max(ms) - min(ms)) / med, "samples": len(ms)}


def _fmt(s):
    return f"median {s['median_ms']:.3f} ms (spread {s['spread']:.3f}, n={s['samples']})"


def _in_turns(run_kern, run_twin, reps=5, batch=1):
    """Kernel and twin timed in turns (twin, kernel, kernel, twin, ...)
    after two warm-ups each, the kernel's samples of ``batch`` calls each;
    returns (kernel, twin) summaries."""
    _time_ms(run_kern, warmup=2, reps=0)
    _time_ms(run_twin, warmup=2, reps=0)
    kern_ms, twin_ms = [], []
    for i in range(reps):
        for fn, acc, n in ((run_twin, twin_ms, 1), (run_kern, kern_ms, batch))[:: 1 if i % 2 == 0 else -1]:
            acc += _time_ms(fn, warmup=0, reps=1, batch=n)
    return _summary(kern_ms), _summary(twin_ms)


def _steps_in_turns(steps, reps=5, batch=1):
    """Several steps timed in turns (each order reversed every other
    round) after two warm-ups each, a sample ``batch`` calls (see
    :func:`_time_ms`); returns {name: summary}."""
    for fn in steps.values():
        _time_ms(fn, warmup=2, reps=0)
    acc = {k: [] for k in steps}
    names = list(steps)
    for i in range(reps):
        for k in names if i % 2 == 0 else names[::-1]:
            acc[k] += _time_ms(steps[k], warmup=0, reps=1, batch=batch)
    return {k: _summary(v) for k, v in acc.items()}


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _profiled(step):
    """One run of ``step`` (after one unprofiled run) under
    ``torch.profiler``: (microseconds between CUDA events around it, its
    kernels' profiler entries by device time, descending).  The
    device-copy cache is emptied before each run, as :func:`_host_ms` does,
    so a public call on numpy inputs is profiled with its uploads."""
    from torch.profiler import ProfilerActivity, profile

    _wrap.clear_device_cache()
    step()
    _wrap.clear_device_cache()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    kernels.sort(key=_device_us, reverse=True)
    return start.elapsed_time(end) * 1e3, kernels


def _profile(label, step, ours):
    """One step under ``torch.profiler``: device busy time, the top 5
    kernels by device time and the port's own kernels (names in ``ours``)."""
    wall_us, kernels = _profiled(step)
    busy_us = sum(_device_us(e) for e in kernels)
    if not kernels:
        print(f"[profile] {label}: torch.profiler recorded no device time", flush=True)
        return
    print(f"[profile] {label}: {wall_us / 1e3:.3f} ms between CUDA events, {busy_us / 1e3:.3f} ms of kernel time "
          f"over {sum(e.count for e in kernels)} kernels (device idle {100 * max(wall_us - busy_us, 0) / wall_us:.1f} %); "
          "top 5 by device time, then the port's own:", flush=True)
    mine = [e for e in kernels if any(k in e.key for k in ours)]
    for e in kernels[:5] + [e for e in mine if e not in kernels[:5]]:
        print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms  {100 * _device_us(e) / busy_us:5.1f}%  x{e.count:<4d} {e.key[:110]}", flush=True)


def _peak(dev, fn):
    """(fn's result, its peak device memory above what was held before it, bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(dev) - base


def second_order_phase(dev, ours, tp, pr_np, scen0):
    """Phase 5e: ExtremeValues on config 2's first-order ``scen0`` (a CUDA
    tensor), PrincipalComponents at 512 sites, OTC / dOTC at one site; each
    through the public calls, on the card, held against the CPU port, timed.
    Returns the launch counts of each path."""
    pref_np, phist_np, psim_np = pr_np
    counts = {}
    cut = slice(0, CHECK_SITES)

    # ExtremeValues: 512 sites x 150 years of pr
    profiling.reset_counters()
    t0 = time.perf_counter()
    (ev, ev_out), peak = _peak(dev, lambda: extremes_run(pref_np, phist_np, psim_np, scen0, tp))
    first_s = time.perf_counter() - t0
    counts["ExtremeValues"] = c = profiling.counters("launch.")
    out = ev_out.data
    assert out.is_cuda and out.dtype == torch.float32 and out.shape == scen0.shape, (out.device, out.dtype, tuple(out.shape))
    assert bool(torch.isfinite(out)[torch.isfinite(scen0)].all()), "ExtremeValues: non-finite where scen is finite"
    assert c["fma"] >= 1 and not any(n for k, n in c.items() if k != "fma"), f"ExtremeValues: launches {c}"
    with xp.set_options(device="cpu"):
        ev_cpu, ev_cpu_out = extremes_run(pref_np[cut], phist_np[cut], psim_np[cut], scen0[cut].cpu(), tp)
    card = {k: ev.ds[k].data[cut].cpu() for k in ("thresh", "ref_params", "af", "px_hist")}
    cpu = {k: ev_cpu.ds[k].data for k in card}
    torch.testing.assert_close(card["thresh"], cpu["thresh"], rtol=EV_THRESH_RTOL, atol=0)
    c_err = _max_abs(card["ref_params"][:, 0], cpu["ref_params"][:, 0])
    af_err = float(((card["af"] - cpu["af"]).abs() / cpu["af"].abs()).nan_to_num(0.0).max())
    scen_err = float(((ev_out.data[cut].cpu() - ev_cpu_out.data).abs() / (ev_cpu_out.data.abs() + 1e-6)).max())
    assert c_err <= EV_FIT_TOL, f"ExtremeValues: fitted ref shapes moved by {c_err:.3g}: {card['ref_params'][:, 0].tolist()} against {cpu['ref_params'][:, 0].tolist()}"
    assert af_err <= EV_RTOL and scen_err <= EV_RTOL, f"ExtremeValues vs the CPU port: af {af_err:.3g}, scen {scen_err:.3g} (relative)"
    print(f"[second-order] ExtremeValues({EV_TRAIN}).adjust({EV_ADJUST}) on config 2's DQM scen, numpy {tuple(out.shape)} f32 -> {out.device}: "
          f"finite where scen is, launches {({k: n for k, n in c.items() if n})}; train+adjust {first_s:.3f} s (first call, host clock), peak {peak / 2**30:.3f} GiB above the held; "
          f"first {CHECK_SITES} sites vs the CPU port: thresh max rel diff {float(((card['thresh'] - cpu['thresh']).abs() / cpu['thresh']).max()):.3g}, "
          f"fitted ref shape max abs diff {c_err:.3g}, af max rel diff {af_err:.3g}, "
          f"scen max rel diff {scen_err:.3g}; second-order values differing from scen: {float((out != scen0).float().mean()):.4f} of all", flush=True)
    del ev_cpu, ev_cpu_out

    refa, hista, sima = (torch.from_numpy(a).to(dev) for a in pr_np)
    T = refa.shape[-1]
    N, C = int((1 - EV_TRAIN["q_thresh"]) * T * 1.05), extremes._cluster_bound(T, EV_TRAIN["q_thresh"])
    tables = [torch.as_tensor(ev.ds[k].data, device=dev) for k in ("px_hist", "af", "thresh")]
    tables[2] = tables[2][..., 0]

    def ev_train_step():
        return extremes._extremes_train_core(refa, hista, 1.0, EV_TRAIN["q_thresh"], None, n_out=N, max_clusters=C)

    def ev_adjust_step():
        return extremes._extremes_adjust_core(sima, scen0, *tables, 1.0, EV_ADJUST["frac"], EV_ADJUST["power"], interp="linear", extrapolation="constant", max_clusters=C)

    for label, step in (("train core (_extremes_train_core)", ev_train_step), ("adjust core (_extremes_adjust_core)", ev_adjust_step)):
        summ = _summary(_time_ms(step))
        _, peak = _peak(dev, step)
        print(f"[time] ExtremeValues {label}, {PR_SITES} sites x {PR_YEARS} yr, {N} table nodes, {C} clusters: "
              f"{PR_SITES * PR_YEARS / (summ['median_ms'] / 1e3):,.0f} gridpoint-years/s ({_fmt(summ)}); peak {peak / 2**30:.3f} GiB above the held", flush=True)
    # the GPD fit alone, on ref's cluster maxima: the golden-section steps are ~30 launches each
    mx = cluster_maxima(refa, tables[2][..., None], 1.0, max_clusters=C) - tables[2][..., None]
    summ = _summary(_time_ms(lambda: gpd_fit_ml(mx)))
    print(f"[time] ExtremeValues GPD fit alone (gpd_fit_ml) on {tuple(mx.shape)} cluster maxima: {_fmt(summ)}", flush=True)
    _profile("one GPD fit (gpd_fit_ml)", lambda: gpd_fit_ml(mx), ours)
    _profile("one ExtremeValues train core", ev_train_step, ours)
    del mx
    scen_da = _pr_da(scen0, tp, "scen")
    tr = _summary(_host_ms(lambda: xp.ExtremeValues.train(_pr_da(pref_np, tp, "ref"), _pr_da(phist_np, tp, "hist"), **EV_TRAIN)))
    ad = _summary(_host_ms(lambda: ev.adjust(_pr_da(psim_np, tp, "sim"), scen_da, **EV_ADJUST)))
    print(f"[time] public ExtremeValues on numpy inputs (host clock): train {_fmt(tr)}; adjust {_fmt(ad)}", flush=True)
    _profile("one ExtremeValues adjust core", ev_adjust_step, ours)
    del refa, hista, sima, tables, ev, ev_out, out
    torch.cuda.empty_cache()

    # PrincipalComponents: config 4's recipe at 512 sites, both orientations
    pref, phist, psim = mbcn_problem(PCA_SITES)
    for orientation in ("simple", "full"):
        profiling.reset_counters()
        t0 = time.perf_counter()
        (pca, scen), peak = _peak(dev, lambda: pca_run(pref, phist, psim, orientation))
        first_s = time.perf_counter() - t0
        counts[f"PrincipalComponents {orientation}"] = c = profiling.counters("launch.")
        assert scen.data.is_cuda and scen.dims == psim.dims and bool(torch.isfinite(scen.data).all()), f"PCA {orientation}: {scen.data.device}"
        assert not any(c.values()), f"PCA {orientation}: a kernel of the port ran: {c}"
        with xp.set_options(device="cpu"):
            pca_cpu, scen_cpu = pca_run(*(first_sites(d, CHECK_SITES) for d in (pref, phist, psim)), orientation)
        t_err = _max_abs(pca.ds["trans"].data[cut].cpu(), pca_cpu.ds["trans"].data)
        s_err = _max_abs(scen.data[cut].cpu(), scen_cpu.data)
        torch.testing.assert_close(pca.ds["trans"].data[cut].cpu(), pca_cpu.ds["trans"].data, rtol=PCA_RTOL, atol=PCA_RTOL)
        torch.testing.assert_close(scen.data[cut].cpu(), scen_cpu.data, rtol=PCA_RTOL, atol=PCA_RTOL)
        blocks = [pca_mod._blocks_MP(d, xp.Grouper("time.month").indexes(d.time), "multivar") for d in (pref, phist)]
        core = _summary(_time_ms(lambda: pc_transform_matrix(*blocks, best_orientation=orientation)))
        _, core_peak = _peak(dev, lambda: pc_transform_matrix(*blocks, best_orientation=orientation))
        api = _summary(_host_ms(lambda: pca_run(pref, phist, psim, orientation)))
        print(f"[second-order] PrincipalComponents({orientation}) monthly on numpy {tuple(scen.data.shape)} f32 -> {scen.data.device}: finite, "
              f"no kernel of the port; {first_s:.3f} s first train+adjust, peak {peak / 2**30:.3f} GiB above the held; first {CHECK_SITES} sites vs the "
              f"CPU port: trans max abs diff {t_err:.3g}, scen max abs diff {s_err:.3g}", flush=True)
        print(f"[time] PrincipalComponents({orientation}) {PCA_SITES} sites x {MBCN_VARS} variables x {MBCN_YEARS} yr: pc_transform_matrix on "
              f"{tuple(blocks[0].shape)} blocks {_fmt(core)}, peak {core_peak / 2**30:.3f} GiB; public train+adjust (host clock) {_fmt(api)}", flush=True)
        del pca, scen, blocks
    del pref, phist, psim
    torch.cuda.empty_cache()

    # OTC / dOTC at one site: the plans solve on the host; the result on the card
    oref, ohist, osim = ot_problem()
    bins = occupied_bins(oref, ohist)
    print(f"[second-order] OT problem: 1 site x 2 variables x {OT_YEARS} yr, monthly; occupied bins a month (hist, ref): {bins}", flush=True)
    for name in OT_RUNS:
        profiling.reset_counters()
        t0 = time.perf_counter()
        got = ot_run(name, oref, ohist, osim)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts[name] = c = profiling.counters("launch.")
        assert got.data.is_cuda and bool(torch.isfinite(got.data).all()) and not any(c.values()), f"{name}: {got.data.device}, launches {c}"
        with xp.set_options(device="cpu"):
            want = ot_run(name, oref, ohist, osim)
        assert torch.equal(got.data.cpu(), want.data), f"{name}: the card's result differs from the CPU port's given the same draws"
        api = _summary(_host_ms(lambda: ot_run(name, oref, ohist, osim)))
        print(f"[second-order] {name} on numpy {tuple(got.data.shape)} -> {got.data.device}: finite, equal to the CPU port given the same draws; "
              f"first call {first_s:.3f} s (the first OTC call builds the EMD library), then {_fmt(api)} "
              f"(host clock: histograms, 12 exact plans in threads, sampling)", flush=True)
    profiling.reset_counters()
    t0 = time.perf_counter()
    sink = ot_run("OTC", oref, ohist, osim, solver="sinkhorn")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    counts["OTC sinkhorn"] = profiling.counters("launch.")
    with xp.set_options(device="cpu"):
        sink_cpu = ot_run("OTC", oref, ohist, osim, solver="sinkhorn")
    moved = float((sink.data.cpu() != sink_cpu.data).any(dim=0).float().mean())
    assert sink.data.is_cuda and bool(torch.isfinite(sink.data).all()) and moved <= MAX_FLIPS, f"OTC sinkhorn: {moved:.4f} of the points moved"
    print(f"[second-order] OTC solver=sinkhorn: plans on the card in PyTorch, {host_s:.3f} s (host clock); {moved:.4f} of the points differ from the "
          f"CPU port's (a plan's last bits move a draw across a row CDF step)", flush=True)
    return counts


def _c5_errors(got, want, n):
    """Per label of the suite, the card's first ``n`` sites against the CPU
    port's: the largest difference over the larger of the CPU value's
    largest magnitude and, for a bias, that of the property it subtracts;
    a trend (ref's is noise about 0) over the suite's largest trend."""
    errs = {}
    for key, w in want.items():
        g = got[key].data
        g = (g[:n] if g.ndim else g).cpu().double()
        w = w.data.double()
        scale = float(w.abs().max())
        if key.endswith("trend"):
            scale = max(float(want[f"{k} trend"].data.abs().max()) for k in ("ref", "sim", "scen"))
        elif key.startswith("bias "):
            scale = max(scale, float(want[f"ref {key[5:]}"].data.abs().max()))
        assert bool((torch.isnan(g) == torch.isnan(w)).all()), f"config 5 {key}: NaN where the CPU port has none"
        errs[key] = float((g - w).abs().nan_to_num(0.0).max()) / max(scale, 1e-30)
    return errs


def config5_phase(dev, ours):
    """Phase 5f: BASELINE config 5 on the card (see the module docstring).
    Returns the QDM kernels' launch counts of each block."""
    from xsdba_tpu_torch import measures, properties

    n_blocks = C5_SITES // C5_BLOCK
    tile = {"ref": [], "scen": []}
    block_counts, qdm_s, suite_s = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    gen_s = 0.0
    for b in range(n_blocks):
        t0 = time.perf_counter()
        t, tas_np, pr_np = config5_block(b)
        tas_d, pr_d = ([torch.from_numpy(a).to(dev) for a in x] for x in (tas_np, pr_np))
        torch.cuda.synchronize()
        gen_s += time.perf_counter() - t0
        coords = config5_coords(b)
        if b == 0:
            # first (it also warms the path up): the block with the jitter's draws made alike on the card and the CPU
            cut = slice(0, CHECK_SITES)
            with SeededDraws(C5_SEED + b):
                gtas, gpr = config5_qdm(xp, t, tas_d, pr_d, coords)
                gsuite = config5_suite(properties, measures, gtas, gpr) | config5_return_values(properties, measures, gtas)
            with SeededDraws(C5_SEED + b), xp.set_options(device="cpu"):
                ctas, cpr = config5_qdm(xp, t, [a[cut] for a in tas_np], [a[cut] for a in pr_np])
                csuite = config5_suite(properties, measures, ctas, cpr) | config5_return_values(properties, measures, ctas)
            scen_err = max(_max_abs(d["scen"].data[cut].cpu(), c["scen"].data) for d, c in ((gtas, ctas), (gpr, cpr)))
            torch.testing.assert_close(gtas["scen"].data[cut].cpu(), ctas["scen"].data, **TOL)
            torch.testing.assert_close(gpr["scen"].data[cut].cpu(), cpr["scen"].data, **TOL)
            errs = _c5_errors(gsuite, csuite, CHECK_SITES)
            tol = lambda key: C5_TREND_RTOL if key.endswith("trend") else C5_FIT_RTOL if key.endswith("rv20") else C5_RTOL  # noqa: E731
            bad = {k: e for k, e in errs.items() if e > tol(k)}
            assert not bad, f"config 5: the card differs from the CPU port on the first {CHECK_SITES} sites: {bad}"
            worst = {cls: max(e for k, e in errs.items() if tol(k) == lim) for cls, lim in (("moments, counts, frequencies", C5_RTOL), ("trend", C5_TREND_RTOL), ("rv20", C5_FIT_RTOL))}
            print(f"[config 5] first {CHECK_SITES} sites of block 0 vs the CPU port (the same draws): scen max abs diff {scen_err:.3g}; "
                  f"largest scaled difference by class {({k: f'{v:.3g}' for k, v in worst.items()})}", flush=True)
            del gtas, gpr, gsuite, ctas, cpr, csuite
        profiling.reset_counters()
        t0 = time.perf_counter()
        tas, pr = config5_qdm(xp, t, tas_d, pr_d, coords)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        suite = config5_suite(properties, measures, tas, pr) | config5_return_values(properties, measures, tas)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = profiling.counters("launch.")
        qdm_s.append(t1 - t0)
        suite_s.append(t2 - t1)
        block_counts.append({k: n for k, n in counts.items() if n})
        # one bracketed lookup a QDM adjust (tas and pr), fma in both trains, no other lookup
        assert counts["interp_bracketed"] == 2 and counts["fma"] >= 1 and counts["interp_table_3d"] == counts["interp_table_2d"] == 0, f"config 5 block {b}: launches {counts}"
        for v, das in (("tas", tas), ("pr", pr)):
            sc = das["scen"].data
            assert sc.device == dev and sc.dtype == torch.float32 and tuple(sc.shape) == (C5_BLOCK, 365 * C5_YEARS) and bool(torch.isfinite(sc).all()), f"config 5 block {b}: {v} scen"
        for key, da in suite.items():
            assert da.data.device == dev and bool(torch.isfinite(da.data).all()), f"config 5 block {b}: {key} on {da.data.device}, finite {bool(torch.isfinite(da.data).all())}"
        tile["ref"].append(tas["ref"].data)
        tile["scen"].append(tas["scen"].data)
        print(f"[config 5] block {b}: {C5_BLOCK} sites x {C5_YEARS} yr of tas and pr f32 on {dev}: QDM train+adjust of both {qdm_s[-1]:.3f} s, "
              f"the suite ({len(suite)} outputs) {suite_s[-1]:.3f} s (host clock, synchronised); every output finite; launches {block_counts[-1]}", flush=True)
        if b < n_blocks - 1:
            del tas, pr, suite
    peak_blocks = torch.cuda.max_memory_allocated(dev) - base

    # the tile: the inter-site Spearman matrix of [2048, 54750] ranks, on the card
    t = xp.date_range("1950-01-01", periods=365 * C5_YEARS, freq="D", calendar="noleap")
    tile_da = {k: xp.DataArray(torch.cat(v), ("site", "time"), {"time": t, **config5_coords(0, C5_SITES)}, {"units": "K"}, "tas") for k, v in tile.items()}
    del tile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_tile = torch.cuda.memory_allocated(dev)
    profiling.reset_counters()
    t0 = time.perf_counter()
    spatial = {
        "correlogram ref": properties.spatial_correlogram(tile_da["ref"]),
        "correlogram scen": properties.spatial_correlogram(tile_da["scen"]),
        "decorrelation length scen": properties.decorrelation_length(tile_da["scen"]),
        "scorr": measures.scorr(tile_da["scen"], tile_da["ref"]),
    }
    torch.cuda.synchronize()
    spatial_s = time.perf_counter() - t0
    peak_tile = torch.cuda.max_memory_allocated(dev) - base_tile
    assert not any(profiling.counters("launch.").values()), f"config 5 spatial: a kernel of the port ran: {profiling.counters("launch.")}"
    with xp.set_options(device="cpu"):
        want = properties.spatial_correlogram(xp.DataArray(tile_da["scen"].data.cpu(), ("site", "time"), dict(tile_da["scen"].coords), {"units": "K"}, "tas"))
    empty = torch.isnan(want.data)   # distance bins that hold no pair of sites
    for key, da in spatial.items():
        finite = torch.isfinite(da.data).cpu()
        assert da.data.device == dev and bool((finite == ~empty).all() if key.startswith("correlogram") else finite.all()), f"config 5 {key}: {da.data.device}, {finite}"
    cg_err = _max_abs(spatial["correlogram scen"].data.cpu(), want.data)
    assert cg_err <= C5_CORRELOGRAM_TOL, f"config 5: the tile's correlogram differs from the CPU port's by {cg_err:.3g}"
    total_s = sum(qdm_s) + sum(suite_s) + spatial_s
    print(f"[config 5] tile {C5_SITES} sites ({C5_LAT} x {C5_LON} at 0.25 deg): spatial correlogram of ref and scen, decorrelation length, Scorr "
          f"{spatial_s:.3f} s (host clock, with the host binning); Scorr {float(spatial['scorr'].data):.6f}, decorrelation length range "
          f"[{float(spatial['decorrelation length scen'].data.min()):.1f}, {float(spatial['decorrelation length scen'].data.max()):.1f}] km; "
          f"{int(empty.sum())} empty distance bins of {empty.numel()}; correlogram vs the CPU port max abs diff {cg_err:.3g}; peak {peak_tile / 2**30:.3f} GiB above the {base_tile / 2**30:.3f} GiB held", flush=True)
    print(f"[time] config 5 pipeline (QDM tas+pr and the suite, 4 blocks, then the tile's spatial properties): {total_s:.3f} s, "
          f"{C5_SITES * C5_YEARS / total_s:,.0f} gridpoint-years/s; the suite {sum(suite_s) + spatial_s:.3f} s "
          f"({100 * (sum(suite_s) + spatial_s) / total_s:.1f} %), QDM {sum(qdm_s):.3f} s; a block's QDM median "
          f"{statistics.median(qdm_s):.3f} s, its suite median {statistics.median(suite_s):.3f} s (block 0's check ran first and warmed the path up); data set-up {gen_s:.3f} s (not counted); "
          f"peak {peak_blocks / 2**30:.3f} GiB above the held over the blocks", flush=True)

    # each property of the last block, and the tile's products, under the profiler
    calls = {
        "QDM train+adjust (tas and pr)": lambda: config5_qdm(xp, t, [tas[k].data for k in ("ref", "hist", "sim")], [pr[k].data for k in ("ref", "hist", "sim")], None),
        "mean": lambda: properties.mean(tas["scen"]),
        "std": lambda: properties.std(tas["scen"]),
        "quantile q=0.98": lambda: properties.quantile(tas["scen"], q=0.98),
        "trend": lambda: properties.trend(tas["scen"]),
        "annual_cycle_amplitude": lambda: properties.annual_cycle_amplitude(tas["scen"]),
        "annual_cycle_phase": lambda: properties.annual_cycle_phase(tas["scen"]),
        "return_value ML": lambda: properties.return_value(tas["scen"], period=20, method="ML"),
        "spell_length_distribution": lambda: properties.spell_length_distribution(pr["scen"], thresh="1 mm/d"),
        "spell_length_distribution monthly": lambda: properties.spell_length_distribution(pr["scen"], thresh="1 mm/d", group="time.month"),
        "relative_frequency": lambda: properties.relative_frequency(pr["scen"], thresh="1 mm/d"),
        "transition_probability": lambda: properties.transition_probability(pr["scen"], thresh="1 mm/d"),
        "corr_btw_var": lambda: properties.corr_btw_var(tas["scen"], pr["scen"]),
        "rmse + mae": lambda: (measures.rmse(tas["scen"], tas["ref"]), measures.mae(tas["scen"], tas["ref"])),
        "annual_cycle_correlation": lambda: measures.annual_cycle_correlation(tas["scen"], tas["ref"]),
        "spatial_correlogram (tile)": lambda: properties.spatial_correlogram(tile_da["scen"]),
        "scorr (tile)": lambda: measures.scorr(tile_da["scen"], tile_da["ref"]),
    }
    named = ("return_value ML", "spatial_correlogram (tile)", "corr_btw_var")
    for label, fn in calls.items():
        wall_us, kernels = _profiled(fn)
        busy = sum(_device_us(e) for e in kernels)
        top = "; top: " + ", ".join(f"{_device_us(e) / 1e3:.3f} ms x{e.count} {e.key[:60]}" for e in kernels[:3]) if label in named else ""
        print(f"[profile] config 5 {label}: {wall_us / 1e3:.3f} ms between CUDA events, {busy / 1e3:.3f} ms of kernel time over "
              f"{sum(e.count for e in kernels)} kernels (device idle {100 * max(wall_us - busy, 0) / max(wall_us, 1e-9):.1f} %){top}", flush=True)
    from xsdba_tpu_torch.ops.fitting import gev_fit_ml
    from xsdba_tpu_torch.properties import _pairwise_spearman

    ext = tas["scen"].data.reshape(C5_BLOCK, C5_YEARS, 365).amax(dim=-1)   # the annual maxima return_value fits
    fit = _summary(_time_ms(lambda: gev_fit_ml(ext), reps=3))
    sp = _summary(_time_ms(lambda: _pairwise_spearman(tile_da["scen"].data), warmup=1, reps=3))
    print(f"[time] config 5 gev_fit_ml alone on [{C5_BLOCK}, {C5_YEARS}] annual maxima: {_fmt(fit)}; _pairwise_spearman alone on "
          f"{tuple(tile_da['scen'].data.shape)}: {_fmt(sp)}", flush=True)
    _profile("config 5 one gev_fit_ml", lambda: gev_fit_ml(ext), ours)
    del tas, pr, suite, tile_da, spatial, ext
    torch.cuda.empty_cache()
    return block_counts


def _signs(got, want):
    """Values of ``got`` that differ from ``want`` by bit pattern (any NaN
    equal to any NaN), counted on the CPU."""
    got, want = got.cpu(), want.cpu()
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int(((_bits(got) != _bits(want)) & ~both_nan).sum())


def c29_phase(dev, gi):
    """The headline core (both kinds), ``nan_quantile`` and ``vecquantiles``
    on ±0.0-tie rows on the card against the CPU port by bit pattern; the
    same with the parent's unstable value sort, counted but not held.
    Returns {check: values checked}."""
    from xsdba_tpu_torch.models import _algos
    from xsdba_tpu_torch.ops import quantile as quant

    t, (ref_np, hist_np, sim_np) = dry_day_problem(N_SITES, N_YEARS)
    q = equally_spaced_nodes(NQ)
    cut = slice(0, CHECK_SITES)
    out = {}

    def core(device, kind, n=None):
        idx = [torch.as_tensor(a, device=device) for a in (gi.gather_idx, gi.group_idx, gi.scatter_slot)]
        return qdm_train_adjust_core(*(torch.from_numpy(a[:n]).to(device) for a in (ref_np, hist_np, sim_np)), *idx, device_brackets(gi, "linear", device),
                                     torch.as_tensor(q, dtype=torch.float32, device=device), kind=kind, interp="linear", extrapolation="constant")

    for kind in ("+", "*"):
        got = core(dev, kind)
        want = core("cpu", kind, CHECK_SITES)
        stable_quantile = _algos.nan_quantile
        _algos.nan_quantile = _unstable_nan_quantile
        try:
            before = _signs(core(dev, kind)[cut], want)
        finally:
            _algos.nan_quantile = stable_quantile
        cpu = got[cut].cpu()
        zeros, negz = int((cpu == 0).sum()), int(((cpu == 0) & torch.signbit(cpu)).sum())
        infs, nans = int(torch.isinf(cpu).sum()), int(torch.isnan(cpu).sum())
        print(f"[c29] headline core kind={kind} on ±0.0-tie rows {tuple(got.shape)}: first {CHECK_SITES} sites against the CPU port, "
              f"{zeros} zeros ({negz} of them -0.0), {infs} infinities, {nans} NaN; the parent's unstable sort on the card: {before} values differ", flush=True)
        _compare_bits(f"C29 headline core kind={kind}, first {CHECK_SITES} sites vs the CPU port", got[cut].cpu(), want)
        out[f"core {kind}"] = want.numel()
    qs = torch.linspace(0, 1, 11, dtype=torch.float32)
    for label, shape in (("short rows", (4096, 30)), ("group rows", (N_SITES * 12, 4650))):
        x = torch.from_numpy(zero_tie_rows(*shape, seed=shape[1]))
        ranks = qs[torch.from_numpy(np.random.default_rng(shape[0]).integers(0, 11, shape[0]))]
        for name, fn, args in (("nan_quantile", quant.nan_quantile, (qs,)), ("vecquantiles", quant.vecquantiles, (ranks,))):
            want = fn(x, *args)
            got = fn(x.to(dev), *(a.to(dev) for a in args))
            before = torch.sort(x.to(dev), dim=-1).values.cpu()
            moved = _signs(before, torch.sort(x, dim=-1, stable=True).values)
            print(f"[c29] {name} on {label} {shape}: {int(((want == 0) & torch.signbit(want)).sum())} of {want.numel()} results -0.0; "
                  f"the card's unstable sort puts {moved} sorted values' bits elsewhere than the stable one", flush=True)
            _compare_bits(f"C29 {name}, {label}, vs the CPU port", got.cpu(), want)
            out[f"{name} {label}"] = want.numel()
    return out


def c31_phase(dev):
    """ROADMAP C31 through the public path: a dayofyear + 31 QDM with
    ``kind="*"`` on :func:`dry_day_problem`'s numpy pr, whose trained
    factors are NaN at the low quantiles (0 / 0), so the adjust's tables
    carry +inf holes and K1 looks values up in them; on the card, with
    ``nearest`` (QDM's default) and ``linear``.  The first CHECK_SITES
    sites' trained factors (ROADMAP C32) and ``scen`` are held to the CPU
    port's (on the merge engine, the card's) by bit pattern.  Returns
    {interp: K1 launches of the adjust}."""
    t, (ref_np, hist_np, sim_np) = dry_day_problem(N_SITES, N_YEARS)
    group = xp.Grouper("time.dayofyear", window=HEAVY_WINDOW)
    train = lambda r, h: xp.QuantileDeltaMapping.train(_pr_da(r, t, "ref"), _pr_da(h, t, "hist"), kind="*", group=group, nquantiles=NQ)  # noqa: E731
    cut = slice(0, CHECK_SITES)
    qdm = train(ref_np, hist_np)
    with xp.set_options(device="cpu", selection_backend=False):   # the CPU's default engine is selection
        qdm_cpu = train(ref_np[cut], hist_np[cut])
    af = qdm.ds["af"].data
    holes = int((torch.isnan(af).any(dim=-1) & ~torch.isnan(af).all(dim=-1)).sum())
    assert af.device.type == torch.device(dev).type and holes > 0, "no trained table with a NaN factor inside"
    # the trained factors against the CPU port's, by bit pattern (ROADMAP
    # C32: the merge kernels and their twins order ±0.0 alike, by IEEE
    # totalOrder, so every factor of 0 / 0, x / ±0.0 and ±0.0 / x matches)
    _compare_bits(f"C32 public dayofyear+{HEAVY_WINDOW} QDM kind=* trained factors, first {CHECK_SITES} sites vs the CPU port",
                  af[cut].cpu(), qdm_cpu.ds["af"].data)
    out = {}
    for interp in ("nearest", "linear"):
        torch.cuda.synchronize()
        profiling.reset_counters()
        scen = qdm.adjust(_pr_da(sim_np, t, "sim"), interp=interp).data
        torch.cuda.synchronize()
        counts = profiling.counters("launch.")
        assert scen.device.type == torch.device(dev).type and counts["interp_table_3d"] >= 1, f"C31 public adjust launches {counts}"
        with xp.set_options(device="cpu", selection_backend=False):
            want = qdm_cpu.adjust(_pr_da(sim_np[cut], t, "sim"), interp=interp).data
        got = scen[cut].cpu()
        print(f"[c31] public dayofyear+{HEAVY_WINDOW} QDM kind=* interp={interp} on dry-day pr {tuple(scen.shape)}: {holes} trained tables "
              f"with a NaN factor inside; launches {counts}; first {CHECK_SITES} sites: {int(torch.isnan(got).sum())} NaN, "
              f"{int(torch.isinf(got).sum())} infinities", flush=True)
        _compare_bits(f"C31 public dayofyear+{HEAVY_WINDOW} QDM kind=* interp={interp}, first {CHECK_SITES} sites vs the CPU port", got, want)
        out[interp] = counts["interp_table_3d"]
    return out


# phase 5g: the cubic lookup, period stacking, additive space, the spectral
# filter and the public lookup at full width
MW_WINDOW, MW_STRIDE, MW_TRAIN_YEARS, MW_CHECK = 30, 10, 30, 4
MBCN_PR_KWS = {"pr": {"kind": "*", "adapt_freq_thresh": "1 mm/d", "jitter_under_thresh_value": "0.01 mm/d"}}
SF_GRID, SF_YEARS, SF_CHECK_DAYS = 100, 30, 365
SF_KW = dict(dims=["lat", "lon"], lam_long="1000 km", lam_short="250 km")
_LOOKUPS = ("interp_table_3d", "interp_table_2d", "interp_bracketed")


def mbcn_pr_problem(n_sites):
    """MBCn-a's data (:func:`mbcn_problem`) with its second variable, pr,
    from config 2's recipe (:func:`pr_problem`, 30 years), in the layout
    ``stack_variables`` gives ([multivar, site, time], each variable's units
    in ``_variable_attrs``), which preprocessing in ``base_kws_vars`` needs."""
    out = []
    _, prs = pr_problem(n_sites, MBCN_YEARS)
    units = {"tasmax": {"units": "K"}, "pr": {"units": "mm/d"}, "huss": {"units": "1"}}
    for da, pr in zip(mbcn_problem(n_sites), prs):
        x = np.moveaxis(da.data, 1, 0).copy()
        x[1] = pr
        out.append(xp.DataArray(x, ("multivar", "site", "time"), dict(da.coords), {"units": "", "_variable_attrs": units}, da.name))
    return out


def _sites(da, n):
    """The first ``n`` sites of a stacked [multivar, site, time] array, on the CPU."""
    return xp.DataArray(da.data[:, :n], da.dims, {**da.coords, "site": np.arange(n)}, dict(da.attrs), da.name)


def spectral_field(dev, seed=31):
    """Config 3's grid: 100 x 100 sites at 0.25 degrees from 40.125 N,
    0.125 E (``lat`` / ``lon`` coordinates) x 30 noleap years of daily f32
    tas, made on the card: a meridional gradient, a zonal wave and N(0, 2)
    noise."""
    T = 365 * SF_YEARS
    lat = 40.125 + 0.25 * np.arange(SF_GRID)
    lon = 0.125 + 0.25 * np.arange(SF_GRID)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, SF_GRID, SF_GRID), generator=g, device=dev, dtype=torch.float32) * 2
    x += 285 - 0.5 * torch.as_tensor(lat - 40, dtype=torch.float32, device=dev)[None, :, None]
    x += 3 * torch.cos(torch.as_tensor(lon, dtype=torch.float32, device=dev) / 2)[None, None, :]
    t = xp.date_range("1991-01-01", periods=T, freq="D", calendar="noleap")
    return xp.DataArray(x, ("time", "lat", "lon"), {"time": t, "lat": lat, "lon": lon}, {"units": "K"}, "tas")


def _rel_err(got, want):
    """Max abs difference over the largest finite |want| (NaN and inf where
    both agree count as equal)."""
    got, want = got.double(), want.double()
    scale = float(torch.nan_to_num(want.abs(), nan=0.0, posinf=0.0, neginf=0.0).max()) or 1.0
    return _max_abs(got, want) / scale


def a7_phase(dev, smi):
    """Phase 5g (module docstring): each item's public calls on numpy inputs
    (everything on the card), its launches counted from 0 around it, held
    against the CPU port.  Returns {item: counts}."""
    from xsdba_tpu_torch.ops import interp as tinterp

    out = {}
    t, (ref, hist, sim) = example_problem(N_SITES, N_YEARS)
    cut = slice(0, CHECK_SITES)

    # 1. cubic QDM on the headline data: no lookup kernel, the spline in PyTorch
    qdm = xp.QuantileDeltaMapping.train(_da(ref, t, "ref"), _da(hist, t, "hist"), group="time.month", nquantiles=NQ, kind="+")
    adjust = lambda: qdm.adjust(_da(sim, t, "sim"), interp="cubic").data  # noqa: E731
    torch.cuda.synchronize()
    profiling.reset_counters()
    scen, peak = _peak(dev, adjust)
    counts = out["cubic QDM"] = profiling.counters("launch.")
    assert scen.device.type == dev.type and bool(torch.isfinite(scen).all()), "cubic QDM: non-finite output"
    assert not any(counts[k] for k in _LOOKUPS) and counts["fma"] >= 1, f"cubic QDM: launches {counts}"
    with xp.set_options(device="cpu"):
        cpu = xp.QuantileDeltaMapping.train(_da(ref[cut], t, "ref"), _da(hist[cut], t, "hist"), group="time.month", nquantiles=NQ, kind="+").adjust(
            _da(sim[cut], t, "sim"), interp="cubic").data
    torch.testing.assert_close(scen[cut].cpu(), cpu, **TOL)
    lin = qdm.adjust(_da(sim, t, "sim"), interp="linear").data
    api = _summary(_host_ms(adjust))
    api_lin = _summary(_host_ms(lambda: qdm.adjust(_da(sim, t, "sim"), interp="linear").data))
    xs, ys, nv = tinterp._pad_cyclic_tables(qdm.ds["hist_q"].data, qdm.ds["af"].data, tables_compact=True)
    slopes = lambda: tinterp._cubic_slopes(xs, ys, nv)  # noqa: E731
    solve = _summary(_time_ms(slopes))
    solve_host = _summary(_host_ms(slopes))
    wall_us, kernels = _profiled(slopes)
    n_solve = sum(e.count for e in kernels)
    print(f"[a7] cubic QDM adjust (monthly, nq {NQ}) {tuple(scen.shape)} f32: finite, launches {counts} (no lookup kernel: the spline is plain PyTorch); "
          f"first {CHECK_SITES} sites vs the CPU port max abs diff {_max_abs(scen[cut].cpu(), cpu):.3g}; differs from linear by up to {_max_abs(scen, lin):.3g} [{smi}]", flush=True)
    print(f"[a7] cubic QDM public adjust (host clock): {_fmt(api)}; linear {_fmt(api_lin)}; ratio {api['median_ms'] / api_lin['median_ms']:.2f} [{smi}]", flush=True)
    print(f"[a7] cubic slope solve at the adjust's padded tables {tuple(xs.shape)}: {n_solve} kernel launches, CUDA events {_fmt(solve)}, "
          f"host clock {_fmt(solve_host)}, profiled {wall_us / 1e3:.3f} ms between events, {sum(_device_us(e) for e in kernels) / 1e3:.3f} ms of kernel time [{smi}]", flush=True)
    print(f"[a7] cubic QDM adjust peak {peak / 2**30:.3f} GiB above the held [{smi}]", flush=True)
    del scen, lin, xs, ys, nv

    # 2. cubic windowed EQM on the heavy data: the merge engine trains, the adjust is cubic
    th, (href, hhist, hsim) = heavy_problem(HEAVY_SITES, HEAVY_YEARS)
    torch.cuda.synchronize()
    profiling.reset_counters()
    t0 = time.perf_counter()
    eqm = xp.EmpiricalQuantileMapping.train(_da(href, th, "ref"), _da(hhist, th, "hist"), group="time.dayofyear", window=HEAVY_WINDOW, nquantiles=NQ, kind="+")
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    train_counts = profiling.counters("launch.")
    assert all(train_counts[k] >= 1 for k in ("sort_rows_alternating", "build_levels", "fold_windows")), f"cubic EQM train: launches {train_counts}"
    profiling.reset_counters()
    hscen, hpeak = _peak(dev, lambda: eqm.adjust(_da(hsim, th, "sim"), interp="cubic").data)
    counts = out["cubic windowed EQM"] = {"train": train_counts, "adjust": profiling.counters("launch.")}
    assert bool(torch.isfinite(hscen).all()) and not any(counts["adjust"][k] for k in _LOOKUPS), f"cubic EQM: launches {counts}"
    hcut = slice(0, HEAVY_CHECK)
    with xp.set_options(device="cpu", selection_backend=False):   # the CPU's default engine is selection
        hcpu = xp.EmpiricalQuantileMapping.train(_da(href[hcut], th, "ref"), _da(hhist[hcut], th, "hist"), group="time.dayofyear", window=HEAVY_WINDOW,
                                                 nquantiles=NQ, kind="+").adjust(_da(hsim[hcut], th, "sim"), interp="cubic").data
    torch.testing.assert_close(hscen[hcut].cpu(), hcpu, **TOL)
    hapi = _summary(_host_ms(lambda: eqm.adjust(_da(hsim, th, "sim"), interp="cubic").data))
    print(f"[a7] cubic windowed EQM (doy+{HEAVY_WINDOW}, nq {NQ}) {tuple(hscen.shape)}: finite, launches {counts}; first {HEAVY_CHECK} sites vs the CPU port "
          f"(merge engine) max abs diff {_max_abs(hscen[hcut].cpu(), hcpu):.3g}; train {train_ms:.3f} ms (first call), adjust {_fmt(hapi)} (host clock), "
          f"adjust peak {hpeak / 2**30:.3f} GiB [{smi}]", flush=True)
    del hscen, eqm

    # 3. moving-window QDM: trained on 30 years, adjusting 150 years as 13
    # stacked 30-year periods moved by a decade
    ty = slice(0, 365 * MW_TRAIN_YEARS)
    t30 = xp.date_range("2000-01-01", periods=365 * MW_TRAIN_YEARS, freq="D", calendar="noleap")

    def mw_train(r=ref, h=hist):
        return xp.QuantileDeltaMapping.train(_da(r[:, ty], t30, "ref"), _da(h[:, ty], t30, "hist"), group="time.month", nquantiles=NQ, kind="+")

    def moving_window(mw, x=sim):
        # the trained tables broadcast against sim's leading dims by position
        # (in both packages), so the period dim goes before the site dim
        stacked = processing.stack_periods(_da(x, t, "sim"), window=MW_WINDOW, stride=MW_STRIDE)
        return stacked, processing.unstack_periods(mw.adjust(stacked.transpose("period", "site", "time"), interp="linear"))

    mw = mw_train()
    torch.cuda.synchronize()
    profiling.reset_counters()
    (stacked, unstacked), mpeak = _peak(dev, lambda: moving_window(mw))
    counts = out["moving-window QDM"] = profiling.counters("launch.")
    assert tuple(stacked.shape) == (N_SITES, (N_YEARS - MW_WINDOW) // MW_STRIDE + 1, 365 * MW_WINDOW) and stacked.data.device.type == dev.type, (tuple(stacked.shape), stacked.data.device)
    back = processing.unstack_periods(stacked).data
    assert torch.equal(back, torch.from_numpy(sim).to(dev)), "stack then unstack is not the series"
    assert bool(torch.isfinite(unstacked.data).all()), "moving-window QDM: non-finite output"
    # the linear adjust's blend is fused into the bracketed launch: no fma
    assert counts["interp_bracketed"] >= 1 and not [k for k in counts if k != "interp_bracketed" and counts[k]], f"moving-window QDM: launches {counts}"
    mcut = slice(0, MW_CHECK)
    with xp.set_options(device="cpu"):
        mcpu = moving_window(mw_train(ref[mcut], hist[mcut]), sim[mcut])[1].data
    torch.testing.assert_close(unstacked.data[mcut].cpu(), mcpu, **TOL)
    mapi = _summary(_host_ms(lambda: moving_window(mw)))
    mlin = _summary(_host_ms(lambda: mw.adjust(_da(sim, t, "sim"), interp="linear").data))
    print(f"[a7] moving-window QDM: stack_periods(window={MW_WINDOW}, stride={MW_STRIDE}) {tuple(sim.shape)} -> {tuple(stacked.shape)} f32 on the card, "
          f"unstacked back equal under ==; stack + adjust + unstack (trained on {MW_TRAIN_YEARS} years) finite, launches {counts}; first {MW_CHECK} sites vs "
          f"the CPU port max abs diff {_max_abs(unstacked.data[mcut].cpu(), mcpu):.3g}; the three {_fmt(mapi)} (host clock), the linear adjust of the "
          f"series {_fmt(mlin)}, ratio {mapi['median_ms'] / mlin['median_ms']:.2f}; peak {mpeak / 2**30:.3f} GiB [{smi}]", flush=True)
    del stacked, unstacked, back, mw

    # 4. MBCn-a's width with config 2's pr and its preprocessing in base_kws_vars
    mref, mhist, msim = mbcn_pr_problem(MBCN_A["sites"])
    n, nq = MBCN_A["check"], MBCN_A["nq"]
    torch.cuda.synchronize()
    profiling.reset_counters()
    t0 = time.perf_counter()
    with SeededDraws(61):
        (mobj, mscen), mpeak = _peak(dev, lambda: run_mbcn(mref, mhist, msim, MBCN_A["group"], nq, base_kws_vars=MBCN_PR_KWS))
    mbcn_s = time.perf_counter() - t0
    counts = out["MBCn pr"] = profiling.counters("launch.")
    data = mscen.data
    assert data.device.type == dev.type and tuple(data.shape) == (MBCN_VARS, MBCN_A["sites"], 365 * MBCN_YEARS) and bool(torch.isfinite(data).all()), "MBCn pr: output"
    want_2d = 2 * MBCN_ITERS + MBCN_VARS   # one chunk: n_iter in the train, n_iter + V in the adjust
    assert counts["interp_table_2d"] == want_2d and counts["fma"] >= 1, f"MBCn pr: launches {counts}"
    assert not [k for k in counts if k not in ("interp_table_2d", "fma") and counts[k]], f"MBCn pr: another kernel of the port ran: {counts}"
    # every variable's scen a reordering of its univariate QDM (pr's on the same draws)
    gi = xp.Grouper(*MBCN_A["group"]).indexes(msim.coords["time"])
    rows = torch.as_tensor(gi.gather_idx, device=data.device)
    with SeededDraws(61):
        uni = torch.stack([
            mbcn._per_block_univariate(*(torch.as_tensor(d.data[iv, :n], device=data.device) for d in (mref, mhist, msim)), rows, rows,
                                       {"nquantiles": nq, **MBCN_PR_KWS.get(v, {})}, {"interp": "nearest", "extrapolation": "constant"},
                                       mref.attrs["_variable_attrs"][v]["units"])[:, 0]
            for iv, v in enumerate(str(v) for v in msim.coords["multivar"])
        ])
    assert torch.equal(torch.sort(data[:, :n], dim=-1).values, torch.sort(uni, dim=-1).values), "MBCn pr: scen is not a reordering of the univariate QDM series"
    rot = mobj.ds["rot_matrices"].data.cpu()
    with xp.set_options(device="cpu"), SeededDraws(61):
        cobj, cscen = run_mbcn(*(_sites(d, n) for d in (mref, mhist, msim)), MBCN_A["group"], nq, rot=rot, base_kws_vars=MBCN_PR_KWS)
    d_af = (mobj.ds["af_q"].data[:n].cpu() - cobj.ds["af_q"].data).abs().amax(dim=(-1, -2))     # [n, G, I]
    assert float(d_af[..., 0].max()) <= MBCN_AF_TOL, f"MBCn pr: af_q differs from the CPU port by {float(d_af[..., 0].max()):.3g} in the first iteration"
    same_values = torch.equal(torch.sort(data[:, :n].cpu(), dim=-1).values, torch.sort(cscen.data, dim=-1).values)
    moved = float((data[:, :n] != uni).float().mean())
    print(f"[a7] MBCn (MBCn-a's width, pr with {MBCN_PR_KWS['pr']}) {tuple(data.shape)}: finite, launches {counts}; scen a reordering of each variable's "
          f"univariate QDM ({100 * moved:.1f} % of the positions moved); first {n} sites vs the CPU port (the card's rotations, the same draws): af_q "
          f"{float(d_af[..., 0].max()):.3g} in the first iteration, {float(d_af.max()):.3g} over all {MBCN_ITERS}; scen's values "
          f"{'equal' if same_values else 'NOT equal'} to the CPU port's, {100 * float((data[:, :n].cpu() == cscen.data).float().mean()):.2f} % of the positions; "
          f"train + adjust {mbcn_s:.3f} s (first call, host clock), peak {mpeak / 2**30:.3f} GiB [{smi}]", flush=True)
    del mobj, mscen, data, uni

    # 5. additive space on config 2's pr
    tp, (pref, _, _) = pr_problem(PR_SITES, PR_YEARS)
    pda = _pr_da(pref, tp, "pr")
    torch.cuda.synchronize()
    profiling.reset_counters()
    (add, back_pr), apeak = _peak(dev, lambda: (lambda a: (a, processing.from_additive_space(a)))(processing.to_additive_space(pda, lower_bound="0 mm/d", trans="log")))
    counts = out["additive space"] = profiling.counters("launch.")
    with xp.set_options(device="cpu"):
        cadd = processing.to_additive_space(_pr_da(pref[:CHECK_SITES], tp, "pr"), lower_bound="0 mm/d", trans="log")
        cback = processing.from_additive_space(cadd)
    add_err, back_err = _rel_err(add.data[cut].cpu(), cadd.data), _rel_err(back_pr.data[cut].cpu(), cback.data)
    trip_err = _rel_err(back_pr.data, torch.from_numpy(pref).to(dev))
    assert add_err <= 2e-6 and back_err <= 2e-6 and trip_err <= 2e-6, (add_err, back_err, trip_err)
    assert add.attrs["xsdba_transform"] == "log" and back_pr.attrs["units"] == "mm/d"
    a_ms = _summary(_host_ms(lambda: processing.from_additive_space(processing.to_additive_space(pda, lower_bound="0 mm/d", trans="log"))))
    print(f"[a7] to_additive_space(log) + from_additive_space {tuple(pref.shape)} f32: launches {counts}; vs the CPU port {add_err:.3g} and {back_err:.3g} of the "
          f"largest value, round trip {trip_err:.3g}; both {_fmt(a_ms)} (host clock), peak {apeak / 2**30:.3f} GiB [{smi}]", flush=True)
    del add, back_pr, pda

    # 6. the spectral filter on config 3's grid, delta estimated from lat
    field = spectral_field(dev)
    torch.cuda.synchronize()
    profiling.reset_counters()
    filt, speak = _peak(dev, lambda: processing.spectral_filter(field, **SF_KW))
    counts = out["spectral filter"] = profiling.counters("launch.")
    assert bool(torch.isfinite(filt.data).all()) and filt.data.dtype == torch.float32
    part = xp.DataArray(field.data[:SF_CHECK_DAYS].cpu(), field.dims, {**field.coords, "time": field.coords["time"].isel(np.arange(SF_CHECK_DAYS))}, dict(field.attrs), field.name)
    with xp.set_options(device="cpu"):
        cfilt = processing.spectral_filter(part, **SF_KW)
    sf_err = _rel_err(filt.data[:SF_CHECK_DAYS].cpu(), cfilt.data)
    assert sf_err <= 2e-6, f"spectral filter: {sf_err:.3g} of the field's scale from the CPU port"
    sf_dev = _summary(_time_ms(lambda: processing.spectral_filter(field, **SF_KW)))
    print(f"[a7] spectral_filter {SF_KW} on {tuple(field.shape)} f32 ({field.data.numel() * 4 / 1e6:.0f} MB, delta {processing.estimate_delta_from_cf(field)}): "
          f"finite, launches {counts}; first {SF_CHECK_DAYS} days vs the CPU port {sf_err:.3g} of the field's scale; CUDA events {_fmt(sf_dev)}, "
          f"peak {speak / 2**30:.3f} GiB [{smi}]", flush=True)
    _profile(f"spectral filter {tuple(field.shape)} [{smi}]", lambda: processing.spectral_filter(field, **SF_KW), ())
    del field, filt

    # the host-to-device copy that every public call on numpy inputs makes
    h2d = _summary(_host_ms(lambda: torch.from_numpy(sim).to(dev)))
    print(f"[a7] host-to-device copy of one numpy {tuple(sim.shape)} f32 ({sim.nbytes / 1e6:.0f} MB, pageable): {_fmt(h2d)} (host clock) [{smi}]", flush=True)

    # 7. the public lookup at the headline shape: grouped (K1 on partition rows) and ungrouped (K2)
    gtabs = (qdm.ds["hist_q"], qdm.ds["af"])
    utabs = tuple(xp.DataArray(d.data[:, 0], ("site", "quantiles"), {"quantiles": d.coords["quantiles"]}, {}, d.name) for d in gtabs)
    for tag, (xq, yq), group, kernel in (("grouped", gtabs, "time.month", "interp_table_3d"), ("ungrouped", utabs, "time", "interp_table_2d")):
        call = lambda: processing.interp_on_quantiles(_da(sim, t, "sim"), xq, yq, group=group, method="linear", mode="blend").data  # noqa: E731
        torch.cuda.synchronize()
        profiling.reset_counters()
        got, ipeak = _peak(dev, call)
        counts = out[f"interp_on_quantiles {tag}"] = profiling.counters("launch.")
        assert counts[kernel] >= 1 and bool(torch.isfinite(got).all()), f"interp_on_quantiles {tag}: launches {counts}"
        sub = lambda d: xp.DataArray(d.data[cut].cpu(), d.dims, dict(d.coords), dict(d.attrs), d.name)  # noqa: E731
        with xp.set_options(device="cpu"):
            want = processing.interp_on_quantiles(_da(sim[cut], t, "sim"), sub(xq), sub(yq), group=group, method="linear", mode="blend").data
        n_diff = int((~_nan_equal(got[cut].cpu(), want)).sum())
        assert n_diff == 0, f"interp_on_quantiles {tag}: {n_diff} values differ from the CPU port"
        ims = _summary(_host_ms(call))
        print(f"[a7] interp_on_quantiles {tag} (linear, blend) {tuple(got.shape)} f32: launches {counts}; first {CHECK_SITES} sites equal to the CPU port "
              f"under ==; {_fmt(ims)} (host clock), peak {ipeak / 2**30:.3f} GiB [{smi}]", flush=True)
        del got
    return out



# phase 5h: the shell modules; the trace must name these kernels (K3, K5, K6, K1)
TRACE_KERNELS = ("sort_rows_warp_kernel", "build_levels_kernel", "fold_windows_kernel", "interp_rows_kernel")
SELFTEST_TOL = 1e-6


def shell_phase(smi, heavy):
    """Phase 5h (module docstring): the CLI's selftest, ``nbutils``,
    ``base.map_groups`` and ``utils.profiling.trace`` on the card, each held
    against the CPU port.  ``heavy`` is (t, ref, hist, sim) of the heavy
    problem on the card.  Returns the trace's launches."""
    import os
    import shutil
    import tempfile

    from xsdba_tpu_torch import base, cli, nbutils

    # 1. the selftest: its EQM on the device option's device (CUDA), then the CPU port's
    t0 = time.perf_counter()
    rc = cli.main(["selftest"])
    selftest_s = time.perf_counter() - t0
    bias, where = cli._selftest_run()
    with xp.set_options(device="cpu"):
        bias_cpu, where_cpu = cli._selftest_run()
    assert rc == 0 and where.type == "cuda" and where_cpu.type == "cpu", (rc, where, where_cpu)
    assert abs(bias - bias_cpu) <= SELFTEST_TOL, f"selftest residual {bias!r} on the card, {bias_cpu!r} on the CPU"
    print(f"[shell] cli selftest: rc {rc} on {where} in {selftest_s:.3f} s (first call, host clock); residual {bias:.9f}, "
          f"the CPU port's {bias_cpu:.9f} (diff {abs(bias - bias_cpu):.3g}, tolerance {SELFTEST_TOL}) [{smi}]", flush=True)

    # 2. nbutils on the headline sim, numpy on the host: each call copies it to the card
    t, (_, _, sim) = example_problem(N_SITES, N_YEARS)
    cut = slice(0, CHECK_SITES)
    q = equally_spaced_nodes(NQ)
    ranks = np.random.default_rng(0).random(N_SITES).astype(np.float32)
    monthly_mean = base.map_groups(group_mean=["<PROP>"])(lambda block, *, dim: block.mean(dim))
    calls = {
        "quantile": lambda da, r: nbutils.quantile(da, q, "time").data,
        "vecquantiles": lambda da, r: nbutils.vecquantiles(da, r, "time").data,
        "map_groups": lambda da, r: monthly_mean(da, group="time.month").data,
    }
    for name, fn in calls.items():
        call = lambda: fn(_da(sim, t, "sim"), ranks)  # noqa: E731
        got = call()
        with xp.set_options(device="cpu"):
            want = fn(_da(sim[cut], t, "sim"), ranks[cut])
        assert got.is_cuda and bool(torch.isfinite(got).all()), f"nbutils {name}: {got.device}, finite {bool(torch.isfinite(got).all())}"
        if name == "map_groups":
            err = _max_abs(got[cut].cpu(), want)
            torch.testing.assert_close(got[cut].cpu(), want, **TOL)
            held = f"max abs diff {err:.3g} (tolerance {TOL['rtol']})"
        else:
            n_diff = int((~_nan_equal(got[cut].cpu(), want)).sum())
            assert n_diff == 0, f"nbutils {name}: {n_diff} values differ from the CPU port"
            held = "equal under =="
        ms = _summary(_host_ms(call))
        label = "base.map_groups monthly mean" if name == "map_groups" else f"nbutils.{name}"
        print(f"[shell] {label} of numpy {sim.shape} f32 -> {tuple(got.shape)} on {got.device}: first {CHECK_SITES} sites vs the CPU port "
              f"{held}; {_fmt(ms)} (host clock, the host-to-device copy in it) [{smi}]", flush=True)
        del got

    # 3. a trace of the heavy windowed EQM's public train and adjust
    th, href, hhist, hsim = heavy
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    logdir = tempfile.mkdtemp(prefix="trace_", dir=build)
    torch.cuda.synchronize()
    profiling.reset_counters()
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        hscen = run_windowed_path(href, hhist, hsim, th)
    trace_s = time.perf_counter() - t0
    counts = profiling.counters("launch.")
    (fname,) = os.listdir(logdir)
    path = os.path.join(logdir, fname)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if str(e.get("cat", "")).lower() == "kernel"]
    named = {k: sum(k in n for n in kernels) for k in TRACE_KERNELS}
    size = os.path.getsize(path)
    shutil.rmtree(logdir)
    assert bool(torch.isfinite(hscen).all()), "traced heavy EQM: non-finite output"
    assert all(named.values()), f"the trace does not name every kernel of the path: {named}"
    assert all(counts[k] >= 1 for k in ("sort_rows_alternating", "build_levels", "fold_windows", "interp_table_3d")), f"traced heavy EQM: launches {counts}"
    print(f"[shell] profiling.trace of the public windowed EQM train+adjust {tuple(hscen.shape)} f32 (doy+{HEAVY_WINDOW}, merge engine): "
          f"{trace_s:.3f} s under the profiler (host clock), a {size / 1e6:.1f} MB Chrome trace of {len(events)} events, {len(kernels)} kernels; "
          f"the path's kernels named: {named}; launches {counts} [{smi}]", flush=True)
    del hscen
    return counts


def parallel_phase(dev, smi):
    """Phase 5i (module docstring): the parallel layer
    (``xsdba_tpu_torch/parallel``) under one NCCL rank, for correctness
    (one card: no speed across cards is measured).  Returns {hold: wall
    seconds}."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from xsdba_tpu_torch.ops.pca import first_eof_pattern
    from xsdba_tpu_torch.parallel import mesh as pmesh

    assert not dist.is_initialized()
    mesh = pmesh.site_mesh("cuda")   # no launcher, no process group: a one-rank world
    walls = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1 and tuple(mesh.shape) == (1,), (dist.get_backend(), mesh)

        # the headline QDM step through shard_sites and the site mesh, against the direct core
        t, data = example_problem(N_SITES, N_YEARS)
        step = monthly_qdm_step(t, dev, nq=NQ)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = [pmesh.shard_sites(a, mesh).to_local() for a in data]
        scen = DTensor.from_local(step(*blocks), mesh, pmesh.site_sharding(mesh, 2)).full_tensor()
        torch.cuda.synchronize()
        walls["QDM step"] = time.perf_counter() - t0
        direct = step(*(torch.from_numpy(a).to(dev) for a in data))
        n_diff = int((~_nan_equal(scen, direct)).sum())
        print(f"[parallel] the headline QDM step {tuple(scen.shape)} through shard_sites on the one-rank NCCL site mesh: {n_diff} of {scen.numel()} "
              f"values differ from the direct core under == ({walls['QDM step']:.3f} s wall, with the upload) [{smi}]", flush=True)
        assert n_diff == 0, "the sharded QDM step differs from the direct core"
        del scen, direct, blocks

        # the pairwise correlation on config 5's 2048-site tile (daily tas
        # ref, float64) against the one-process product (TF32 off)
        tile = np.concatenate([config5_block(b)[1][0] for b in range(C5_SITES // C5_BLOCK)]).astype(np.float64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        corr = pmesh.sharded_pairwise_corr(pmesh.shard_sites(tile, mesh), mesh).full_tensor()
        torch.cuda.synchronize()
        walls["pairwise corr"] = time.perf_counter() - t0
        x = torch.from_numpy(tile).to(dev)
        x = x - x.mean(dim=-1, keepdim=True)
        nrm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
        x = x / torch.where(nrm == 0, 1, nrm)
        torch.backends.cuda.matmul.allow_tf32 = False
        want = x @ x.T
        torch.backends.cuda.matmul.allow_tf32 = tf32
        print(f"[parallel] sharded_pairwise_corr on config 5's tile {tuple(tile.shape)} f64 -> {tuple(corr.shape)}: max abs diff from the "
              f"one-process product {_max_abs(corr, want):.3g} ({walls['pairwise corr']:.3f} s wall, with the upload) [{smi}]", flush=True)
        torch.testing.assert_close(corr, want, rtol=1e-12, atol=1e-12)
        del corr, want, x

        # the leading EOF of the tile's annual means [2048, 150] against first_eof_pattern
        annual = tile.reshape(C5_SITES, C5_YEARS, 365).mean(axis=-1)
        del tile
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eof, frac = pmesh.sharded_first_eof(annual, mesh)
        eof, frac = eof.full_tensor(), float(frac.to_local())
        torch.cuda.synchronize()
        walls["first EOF"] = time.perf_counter() - t0
        want_v, want_frac = first_eof_pattern(torch.from_numpy(annual - annual.mean(axis=1, keepdims=True)).to(dev).T)
        print(f"[parallel] sharded_first_eof on the tile's annual means {annual.shape} f64: max abs diff from first_eof_pattern "
              f"{_max_abs(eof, want_v):.3g}, var_frac {frac!r} against {float(want_frac)!r} ({walls['first EOF']:.3f} s wall) [{smi}]", flush=True)
        torch.testing.assert_close(eof, want_v, rtol=0, atol=1e-10)
        assert abs(frac - float(want_frac)) <= 1e-10 * abs(float(want_frac)), (frac, float(want_frac))

        # the rotation on a (1, 1) site x var mesh at MBCn-b's shape (its
        # first chunk's blocks of every site, V, the window's values)
        mesh2 = init_device_mesh("cuda", (1, 1), mesh_dim_names=(pmesh.SITE_AXIS, pmesh.VAR_AXIS))
        _, _, b_width, b_chunk = mbcn_chunks(MBCN_B["sites"], MBCN_B["group"])
        g = torch.Generator(device=dev).manual_seed(41)
        xr = torch.randn(MBCN_B["sites"] * b_chunk, MBCN_VARS, b_width, generator=g, device=dev)
        rot = torch.randn(MBCN_VARS, MBCN_VARS, generator=g, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pmesh.sharded_rotation_apply(rot, xr, mesh2).full_tensor()
        torch.cuda.synchronize()
        walls["rotation"] = time.perf_counter() - t0
        torch.backends.cuda.matmul.allow_tf32 = False
        want = torch.matmul(rot, xr)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        print(f"[parallel] sharded_rotation_apply on a (1, 1) site x var mesh {tuple(xr.shape)} f32: max abs diff from torch.matmul "
              f"{_max_abs(y, want):.3g} ({walls['rotation']:.3f} s wall) [{smi}]", flush=True)
        torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        dist.destroy_process_group()
    return walls


def _parse(argv):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--merge-against", action="append", default=[], metavar="LABEL=SOURCE[,NVCC_FLAG...]",
                    help="time another merge_kernel.cu's kernels in turns with this checkout's (phase 6)")
    args = ap.parse_args(argv)
    bad = [spec for spec in args.merge_against if "=" not in spec.split(",")[0]]
    if bad:
        ap.error(f"--merge-against takes LABEL=SOURCE[,NVCC_FLAG...], got {bad}")
    return {spec.split("=", 1)[0]: spec.split("=", 1)[1] for spec in args.merge_against}


def main(argv=None) -> int:
    merge_others = _parse(argv)
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}), {torch.cuda.device_count()} device(s): {smi}", flush=True)

    # 2. build: every source at once
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    print(f"[build] {', '.join(f'{p.name} ({s:.2f} s)' for p, s in built.values())}; {time.perf_counter() - t0:.2f} s in all", flush=True)

    # 3. each kernel against its twin, on the inputs of its path
    err = {}
    t, (ref_np, hist_np, sim_np) = example_problem(N_SITES, N_YEARS)
    gi = xp.Grouper("time.month").indexes(t)
    Gp, Lp = gi.bracket_partitions("linear")["part0"].shape
    v, xs, ys, nv = lookup_inputs(N_SITES, Gp, Lp, NQ, seed=1, device=dev)
    lookup = lambda: interp_kernel.interp_table_3d(v, xs, ys, nv)  # noqa: E731
    lookup_twin = lambda: interp_kernel.interp_table_3d_reference(v, xs, ys, nv)  # noqa: E731
    err["K1"] = _compare(f"K1 lookup nq={NQ}", lookup(), lookup_twin())
    v2, xs2, ys2, nv2 = (a.reshape(N_SITES, -1).contiguous() for a in lookup_inputs(N_SITES, 1, 365 * N_YEARS, NQ, seed=2, device=dev))
    nv2 = nv2.reshape(N_SITES)
    lookup2 = lambda: interp_kernel.interp_table_2d(v2, xs2, ys2, nv2)  # noqa: E731
    lookup2_twin = lambda: interp_kernel.interp_table_2d_reference(v2, xs2, ys2, nv2)  # noqa: E731
    err["K2"] = _compare(f"K2 row lookup nq={NQ}", lookup2(), lookup2_twin())
    # the lookup's other shapes: the windowed adjust's short partition rows
    # (a warp a row), one value, lengths on and off a multiple of 4 and
    # around the short-row limit, every table width's edge, a view that
    # starts off 16 bytes
    k1 = (interp_kernel.interp_table_3d, interp_kernel.interp_table_3d_reference)
    k2 = (interp_kernel.interp_table_2d, interp_kernel.interp_table_2d_reference)
    hgp, hlp = xp.Grouper("time.dayofyear", window=HEAVY_WINDOW).indexes(heavy_problem(1, HEAVY_YEARS)[0]).bracket_partitions("linear")["part0"].shape
    vh, xsh, ysh, nvh = lookup_inputs(HEAVY_SITES, hgp, hlp, NQ, seed=3, device=dev)
    lookup_short = lambda: interp_kernel.interp_table_3d(vh, xsh, ysh, nvh)  # noqa: E731
    lookup_short_twin = lambda: interp_kernel.interp_table_3d_reference(vh, xsh, ysh, nvh)  # noqa: E731
    _hold(err, "K1", f"K1 lookup, short rows nq={NQ}", *k1, vh, xsh, ysh, nvh)
    _hold(err, "K1", f"K1 lookup, short rows, the search's edges nq={NQ}", *k1, *lookup_inputs(16, hgp, hlp, NQ, seed=5, device=dev, extra=True))
    # the nearest method on the same cases: the same kernel, the same twin
    _hold(err, "K1 nearest", f"K1 nearest lookup nq={NQ}", *k1, v, xs, ys, nv, "nearest")
    # config 2's adjust: nearest on the monthly partition's long rows, also with the search's edges
    _hold(err, "K1 nearest (long rows)", f"K1 nearest lookup, long rows nq={NQ}", *k1, v, xs, ys, nv, "nearest")
    _hold(err, "K1 nearest (long rows)", f"K1 nearest lookup, long rows, the search's edges nq={NQ}", *k1, *lookup_inputs(8, Gp, Lp, NQ, seed=13, device=dev, extra=True), "nearest")
    _hold(err, "K2 nearest", f"K2 nearest row lookup nq={NQ}", *k2, v2, xs2, ys2, nv2, "nearest")
    _hold(err, "K1 nearest", f"K1 nearest lookup, short rows nq={NQ}", *k1, vh, xsh, ysh, nvh, "nearest")
    _hold(err, "K1 nearest", f"K1 nearest lookup, short rows, the search's edges nq={NQ}", *k1, *lookup_inputs(16, hgp, hlp, NQ, seed=5, device=dev, extra=True), "nearest")
    short = interp_kernel.SHORT_ROW
    for B, gp, lp, nq in ((7, 3, 1, 1), (5, 4, 3, 2), (3, 5, 150, 64), (3, 5, short - 1, 50), (3, 5, short, 2), (2, 3, short + 1, 64), (4, 6, 700, 20), (2, 3, 4650, 1)):
        edges = lookup_inputs(B, gp, lp, nq, seed=lp + nq, device=dev, extra=True)
        rows = tuple(a.reshape((B * gp,) + a.shape[2:]) for a in edges)
        _hold(err, "K1", f"K1 lookup nq={nq}", *k1, *edges)
        _hold(err, "K2", f"K2 row lookup nq={nq}", *k2, *rows)
        _hold(err, "K1 nearest", f"K1 nearest lookup nq={nq}", *k1, *edges, "nearest")
        _hold(err, "K2 nearest", f"K2 nearest row lookup nq={nq}", *k2, *rows, "nearest")
    # rank-like values in [0, 1] at the two MBCn shapes (a: long rows, b: a warp a row)
    rank_a = rank_lookup_inputs(MBCN_A["sites"] * MBCN_VARS, 365 * MBCN_YEARS, MBCN_A["nq"], seed=11, device=dev)
    b_chunks, b_blocks, b_width, b_chunk = mbcn_chunks(MBCN_B["sites"], MBCN_B["group"])
    assert (b_chunks, b_blocks, b_width, b_chunk) == (2, 365, 930, 187), (b_chunks, b_blocks, b_width, b_chunk)   # two chunks, the second shorter
    rank_b = rank_lookup_inputs(MBCN_B["sites"] * MBCN_VARS * b_chunk, b_width, MBCN_B["nq"], seed=12, device=dev)
    for tag, args in (("MBCn-a", rank_a), ("MBCn-b", rank_b)):
        _hold(err, "K2 nearest", f"K2 nearest row lookup, ranks, {tag} nq={args[1].shape[-1]}", *k2, *args, "nearest")
        _hold(err, "K2", f"K2 row lookup, ranks, {tag} nq={args[1].shape[-1]}", *k2, *args)
    ve = edges[0]
    off = torch.cat([ve.new_zeros(1), ve.reshape(-1)])[1:].reshape(ve.shape)  # contiguous, 4 bytes off a 16-byte boundary
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    err["K1"] = max(err["K1"], _compare("K1 lookup, values off 16 bytes", k1[0](off, *edges[1:]), k1[1](*edges)))
    err["K1 nearest"] = max(err["K1 nearest"], _compare("K1 nearest lookup, values off 16 bytes", k1[0](off, *edges[1:], "nearest"), k1[1](*edges, "nearest")))
    del off, ve, edges, rows

    # the bracketed lookup by bit pattern (any NaN equal to any NaN): at the
    # headline shape with the monthly brackets (also with the search's
    # edges), at a small odd shape with random brackets (w = 0 and 1,
    # g0 == g1), and on the redesign's edges (bracket_cases): nq 1, 2, 49,
    # 62, 63 and 64 (each search depth and its boundary), Gp 1, 14 and 46, rows
    # shorter than a chunk, of a length not a multiple of 4, of exactly one
    # and two chunks, values 4 and 8 bytes off 16, step arrays off 16 bytes,
    # and group ids outside [0, Gp)
    kbr = (interp_kernel.interp_bracketed, interp_kernel.interp_bracketed_reference)
    mb = gi.bracket_partitions("linear")
    bargs = bracket_inputs(N_SITES, Gp, NQ, mb["g0"], mb["g1"], mb["w"], seed=4, device=dev)
    bracketed = lambda: interp_kernel.interp_bracketed(*bargs)  # noqa: E731
    bracketed_twin = lambda: interp_kernel.interp_bracketed_reference(*bargs)  # noqa: E731
    _hold_bits(err, "bracketed", f"bracketed lookup, monthly brackets nq={NQ} Gp={Gp}", *kbr, *bargs)
    _hold_bits(err, "bracketed", f"bracketed lookup, monthly brackets, the search's edges nq={NQ}", *kbr,
               *bracket_inputs(16, Gp, NQ, mb["g0"], mb["g1"], mb["w"], seed=9, device=dev, extra=True))
    rng = np.random.default_rng(6)
    odd_w = rng.random(1001)
    odd_w[::5], odd_w[1::5] = 0.0, 1.0
    odd_g0 = rng.integers(0, 5, 1001)
    odd_g1 = np.where(rng.random(1001) < 0.2, odd_g0, rng.integers(0, 5, 1001))
    _hold_bits(err, "bracketed", "bracketed lookup, random brackets nq=7 Gp=5", *kbr, *bracket_inputs(3, 5, 7, odd_g0, odd_g1, odd_w, seed=7, device=dev, extra=True))
    for label, args in bracket_cases(dev).items():
        _hold_bits(err, "bracketed", f"bracketed lookup, {label}", *kbr, *args)
    # the row lookups on tables with +inf holes (ROADMAP C31, repaired: a
    # row out of order is searched by value), by bit pattern (any NaN equal
    # to any NaN): K1 on the monthly partition's long rows (a block a tile)
    # and on the windowed adjust's short rows (a warp a row), K2 on the long
    # rows flattened, each method, also with the search's edges
    hxs, hys, hnv = (a.to(dev) for a in holey_tables(N_SITES, Gp, NQ, seed=15))
    hxsh, hysh, hnvh = (a.to(dev) for a in holey_tables(HEAVY_SITES, hgp, NQ, seed=16))
    vedge = lookup_inputs(8, Gp, Lp, NQ, seed=17, device=dev, extra=True)[0]
    flat = lambda *a: tuple(x.reshape((-1,) + x.shape[2:]) for x in a)  # noqa: E731
    for method, (k1_key, k2_key) in (("linear", ("K1", "K2")), ("nearest", ("K1 nearest", "K2 nearest"))):
        _hold_bits(err, k1_key, f"K1 {method} on tables with +inf holes, long rows nq={NQ}", *k1, v, hxs, hys, hnv, method)
        _hold_bits(err, k1_key, f"K1 {method} on tables with +inf holes, short rows nq={NQ}", *k1, vh, hxsh, hysh, hnvh, method)
        _hold_bits(err, k1_key, f"K1 {method} on tables with +inf holes, the search's edges nq={NQ}", *k1, vedge, hxs[:8], hys[:8], hnv[:8], method)
        _hold_bits(err, k2_key, f"K2 {method} on tables with +inf holes, rows nq={NQ}", *k2, *flat(v, hxs, hys, hnv), method)
        _hold_bits(err, k1_key, f"K1 {method} on shuffled tables, the search's edges nq={NQ}", *k1, vedge, *shuffled_tables(hxs[:8], hys[:8], seed=18), hnv[:8], method)
        _hold_bits(err, k1_key, f"K1 {method} on shuffled tables, short rows nq={NQ}", *k1, vh[:8], *shuffled_tables(hxsh[:8], hysh[:8], seed=19), hnvh[:8], method)
    del hxs, hys, hnv, vedge

    # the fused multiply-add against its emulation by bit pattern (any NaN
    # equal to any NaN) on its edge cases, each layout class its kernel
    # serves (the rows kernel: contiguous and 16-byte aligned, a view one
    # value off alignment, fewer values than a vector and a count not a
    # multiple of 4, a trailing and a leading broadcast, 0-dim operands; the
    # strided fallback: a transposed operand), then at the shapes the paths
    # give it: the heavy extraction's lerp on the tensors phase 6 times (rows
    # [2 * sites, doy, nq] against a [doy, nq] gamma; also in float64 and with
    # gamma expanded), the same shape on the edge-case values, the QDM step's
    # virtual index ([sites, 12, 1] * [nq] + [nq]) and same-shape lerp, and
    # the selection step's lerp on slices of its [2 * sites, doy, 2 nq + 1]
    # picks, and ExtremeValues' operands (extremes_fma_inputs)
    fa, fc = torch.randn(2, 2 * HEAVY_SITES, 365, NQ, device=dev)
    fb = torch.rand(365, NQ, device=dev)
    fma_paths = set()
    for dtype in (torch.float32, torch.float64):
        a, b, c = fma_inputs(2 * SEL_SITES * 365 * (2 * NQ + 1), dtype, seed=8, device=dev)  # the largest below
        n = 1_000_003
        cases = {
            "same shape, n % 4 = 3": (a[:n], b[:n], c[:n]),
            "contiguous, 16-byte aligned": (a[:1_000_000], b[:1_000_000], c[:1_000_000]),
            "a view one value off 16 bytes": (a[1:1_000_001], b[:1_000_000], c[:1_000_000]),
            "3 values (below one vector)": (a[:3], b[:3], c[:3]),
            "1 value": (a[:1], b[:1], c[:1]),
            "broadcast": (a[:1_000_000].reshape(250, 80, 50), b[:4000].reshape(80, 50), c[:250].reshape(250, 1, 1)),
            "trailing broadcast (a value a row)": (a[:1_000_000].reshape(250, 4000), b[:1_000_000].reshape(250, 4000), c[:250].reshape(250, 1)),
            "leading broadcast (a repeated row)": (a[:1_000_000].reshape(250, 4000), b[:4000], c[:4000].reshape(1, 4000)),
            "0-dim operands": (a[:100_001], b[7].reshape(()), c[9].reshape(())),
            "transposed operand": (a[:1_000_000].reshape(250, 50, 80).transpose(1, 2), b[:4000].reshape(80, 50), c[:250].reshape(250, 1, 1)),
        }
        for label, args in cases.items():
            fma_paths.add(_hold_fma(err, f"{dtype} {label}", *args))
        timed = (fa.to(dtype), fb.to(dtype), fc.to(dtype))
        _hold_fma(err, f"{dtype} heavy lerp, the timed operands", *timed)
        _hold_fma(err, f"{dtype} heavy lerp, gamma expanded", timed[0], timed[1].expand_as(timed[0]).contiguous(), timed[2])
        _hold_fma(err, f"{dtype} heavy lerp, edge values", a[: fa.numel()].reshape(fa.shape), b[: fb.numel()].reshape(fb.shape), c[: fc.numel()].reshape(fc.shape))
        count, node = a[: N_SITES * 12].reshape(N_SITES, 12, 1), b[:NQ]
        _hold_fma(err, f"{dtype} QDM virtual index", count, node, c[:NQ])
        lerp = tuple(x[: N_SITES * 12 * NQ].reshape(N_SITES, 12, NQ) for x in (a, b, c))
        _hold_fma(err, f"{dtype} QDM lerp", *lerp)
        picks = a.reshape(2 * SEL_SITES, 365, 2 * NQ + 1)
        gamma = b[: 2 * SEL_SITES * 365 * NQ].reshape(2 * SEL_SITES, 365, NQ)
        _hold_fma(err, f"{dtype} selection lerp on slices", picks[..., NQ : 2 * NQ], gamma, picks[..., :NQ])
        del a, b, c, cases, timed, count, node, lerp, picks, gamma
        for label, args in extremes_fma_inputs(PR_SITES, 365 * PR_YEARS, dtype, seed=10, device=dev).items():
            _hold_fma(err, f"{dtype} ExtremeValues {label}", *args)
        del args
    assert fma_paths == {"rows", "strided"}, fma_paths

    th, (href_np, hhist_np, hsim_np) = heavy_problem(HEAVY_SITES, HEAVY_YEARS)
    href, hhist, hsim = (torch.from_numpy(a).to(dev) for a in (href_np, hhist_np, hsim_np))
    plan = xp.Grouper("time.dayofyear", window=HEAVY_WINDOW).indexes(th).merge_plan
    G = plan.w1_gather.shape[0] - 2 * plan.half
    slab, _, L = merge_slab(torch.stack([href, hhist]), plan)
    ymax = plan.w1_gather.shape[1]
    err["K3"] = _compare_bits("K3 row sort (warp)", merge.sort_rows_alternating(slab), merge.sort_rows_alternating_reference(slab))
    # the warp sort at 1 and 32 values a lane, and the long-row variant:
    # the heavy slab's rows cut to 32 values, padded with +inf to 1024, 2048
    for width in (32, 1024, 2048):
        wide = widened(slab, width)
        variant = "warp" if merge.row_sort_in_warp(width) else "long-row variant"
        err["K3"] = max(err["K3"], _compare_bits(f"K3 row sort m={width} ({variant})", merge.sort_rows_alternating(wide), merge.sort_rows_alternating_reference(wide)))
        del wide
    ordered = merge.sort_rows_alternating(slab)
    assert merge.levels_in_shared(ordered.shape[-1], L, 4, merge.fold_smem_limit(torch.float32, dev))
    levels = merge.build_levels(ordered, L)
    err["K5"] = _compare_bits(f"K5 level build L={L} (shared memory)", levels, merge.build_levels_reference(ordered, L))
    folded = merge.fold_windows(ordered, levels, HEAVY_WINDOW, G, ymax=ymax)
    err["K6"] = _compare_bits(f"K6 window fold w={HEAVY_WINDOW}", folded, merge.fold_windows_reference(ordered, levels, HEAVY_WINDOW, G, folded.shape[-1]))
    lead = slice(0, 16)  # the composed twins (sort, levels, fold) on the first 16 rows
    o16 = merge.sort_rows_alternating_reference(slab[lead].contiguous())
    composed = merge.fold_windows_reference(o16, merge.build_levels_reference(o16, L), HEAVY_WINDOW, G, folded.shape[-1])
    err["K6"] = max(err["K6"], _compare_bits("K3+K5+K6 against the composed twins, first 16 rows", folded[lead], composed))
    del folded, composed, o16
    plan5 = xp.Grouper("time.dayofyear", window=SMALL_WINDOW).indexes(th).merge_plan
    slab5, _, _ = merge_slab(torch.stack([href, hhist]), plan5)
    ordered5 = merge.sort_rows_alternating(slab5)
    merged5 = merge.merged_window_rows(ordered5, SMALL_WINDOW, G, ymax=ymax)
    err["K4"] = _compare_bits(f"K4 per-group merge w={SMALL_WINDOW}", merged5, merge.merged_window_rows_reference(ordered5, SMALL_WINDOW, G, merged5.shape[-1]))
    del merged5
    # ±0.0 ties (ROADMAP C32): every merge kernel on dry-day pr's slabs
    ties = merge_tie_diffs(merge_tie_slabs(HEAVY_SITES, HEAVY_YEARS, dev))
    print(f"[kernel] K3 (f32, f64, long rows), K4, K5, K6 on ±0.0 ties (dry-day pr, windows {HEAVY_WINDOW} and {SMALL_WINDOW}): "
          f"values differing from the twins by bit pattern {ties}", flush=True)
    assert not any(ties.values()), f"merge kernels and twins disagree on ±0.0 ties: {ties}"
    # the fold's second variant: f64, window 31, 900 values a row (223,200
    # bytes, the merge rounds' second buffer in the output row), about 40 %
    # of the values ±0.0
    big = np.random.default_rng(5).normal(0, 1, (2, 48, 1024))
    big[np.random.default_rng(6).random(big.shape) < 0.3] = 0.0
    big[np.random.default_rng(7).random(big.shape) < 0.15] = -0.0
    big[..., 900:] = np.inf
    big = merge.sort_rows_alternating(torch.from_numpy(big).to(dev))
    limit64 = merge.fold_smem_limit(torch.float64, dev)
    assert not merge.fold_scratch_in_shared(31 * 900, 8, limit64) and not merge.levels_in_shared(1024, L, 8, limit64)
    big_levels = merge.build_levels(big, L)
    err["K5"] = max(err["K5"], _compare_bits(f"K5 level build f64 L={L} m=1024 (merged in device memory)", big_levels, merge.build_levels_reference(big, L)))
    _compare_bits("K6 window fold f64 w=31 ymax=900 m=1024 (scratch in the output row)",
                  merge.fold_windows(big, big_levels, HEAVY_WINDOW, 3, ymax=900),
                  merge.merged_window_rows_reference(big, HEAVY_WINDOW, 3, HEAVY_WINDOW * 900))
    del big, big_levels
    sth, sel_np = heavy_problem(SEL_SITES, HEAVY_YEARS)
    sref, shist, ssim = (torch.from_numpy(a).to(dev) for a in sel_np)
    key7, lab7 = selection_stage1(sref, shist, plan)
    err["K7"] = _compare_sort("selection stage 1", key7, lab7)
    _compare_sort("one row of 2^20", *sort_inputs(1, 1 << 20, seed=4, device=dev))
    _compare_sort("ties, +-0.0 and +inf", *sort_inputs(3, 1000, seed=3, device=dev))
    for T in (sort.TILE - 1, sort.TILE, sort.TILE + 1):
        _compare_sort(f"T = {T} (tile {sort.TILE})", *sort_inputs(2, T, seed=T, device=dev))
    _compare_sort("all-equal rows", torch.full((2, 54750), 2.5, device=dev), lab7[:2].contiguous())

    # the emission kernel against its twin, by bit pattern (a selected -0.0
    # is +0.0 in both): EMIT_CHECK sites of the selection data (ref and hist
    # rows) at windows 5 and 31, f32 (stage 1 by K7) and f64 (torch.sort),
    # finite and NaN-masked (two sites all NaN); wet-day rows of both zero
    # signs with the twin's slots at EMIT_WET_SLOTS, where it overflows and
    # reruns at nq slots; then the selection path's first site chunk of its
    # 2 * SEL_SITES rows, the shape its emission runs at (timed in phase 6)
    sel_masked = nan_masked(sel_np)
    err["emit"] = 0.0
    for window in (SMALL_WINDOW, HEAVY_WINDOW):
        wplan = xp.Grouper("time.dayofyear", window=window).indexes(sth).merge_plan
        for dtype in (torch.float32, torch.float64):
            for tag, arrays in (("finite", sel_np), ("NaN-masked", sel_masked)):
                x = torch.from_numpy(np.stack([a[:EMIT_CHECK] for a in arrays[:2]]).reshape(2 * EMIT_CHECK, -1)).to(dev, dtype)
                err["emit"] = max(err["emit"], _compare_emit(f"window={window} {dtype} {tag}", emit_operands(x, wplan)))
    wet = wet_day_rows(EMIT_WET_ROWS, sel_np[0].shape[1])
    for dtype in (torch.float32, torch.float64):
        wops = emit_operands(torch.from_numpy(wet).to(dev, dtype), plan)
        assert emit_overflows(wops, EMIT_WET_SLOTS), "the wet-day rows no longer overflow the twin's slots"
        err["emit"] = max(err["emit"], _compare_emit(f"wet days, +-0.0 ties, twin slots={EMIT_WET_SLOTS} (overflowed: rerun at nq) {dtype}", wops, EMIT_WET_SLOTS))
    del wops
    # synthetic labels (emit_edge_operands): G = 1, 12, 365, 366 and the
    # packing's largest, 1023 (the most shared memory: 182,256 bytes in
    # float64), windows 1, 5 and 31 (wrapping intervals; with G at or below
    # the window every value in every group), an all-NaN row and a group with
    # no valid value, +-0.0 ties, chunks of 8192 values and of 192 (a
    # partial tile)
    for G_e in EMIT_EDGE_GROUPS:
        for window in (1, SMALL_WINDOW, HEAVY_WINDOW):
            for dtype in (torch.float32, torch.float64):
                for nbc in (128, 3):
                    ops = emit_edge_operands(4, EMIT_EDGE_T, G_e, window, dtype, seed=G_e + window, device=dev, nb_chunk=nbc)
                    err["emit"] = max(err["emit"], _compare_emit(f"synthetic G={G_e} window={window} {dtype}", ops))
    del ops
    e_rows = max_chunk(int(plan.fast_mask.shape[0]), NQ, sel_np[0].shape[1], mode="emit")
    eops = emit_operands(torch.cat([sref, shist])[:e_rows].contiguous(), plan)
    err["emit"] = max(err["emit"], _compare_emit(f"selection path's site chunk ({e_rows} of {2 * SEL_SITES} rows)", eops))

    # 4. headline QDM through the public API
    ref, hist, sim = (torch.from_numpy(a).to(dev) for a in (ref_np, hist_np, sim_np))
    torch.cuda.synchronize()
    profiling.reset_counters()
    t0 = time.perf_counter()
    scen = run_main_path(ref, hist, sim, t)
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    qdm_counts = profiling.counters("launch.")
    assert scen.is_cuda and scen.dtype == torch.float32, (scen.device, scen.dtype)
    assert tuple(scen.shape) == (N_SITES, 365 * N_YEARS), tuple(scen.shape)
    assert bool(torch.isfinite(scen).all()), "non-finite output"
    # one adjust: both brackets' lookups and the blend in one bracketed launch, no partition lookup
    assert qdm_counts["interp_bracketed"] == 1 and qdm_counts["interp_table_3d"] == 0, f"QDM path launches {qdm_counts}"
    assert qdm_counts["fma"] >= 1, f"QDM path launches {qdm_counts}"
    cut = slice(0, CHECK_SITES)
    want = run_main_path(*(torch.from_numpy(a[cut]) for a in (ref_np, hist_np, sim_np)), t)
    cpu_err = float((scen[cut].cpu() - want).abs().max())
    torch.testing.assert_close(scen[cut].cpu(), want, **TOL)
    print(f"[main path] QDM train+adjust {tuple(scen.shape)} f32 on {dev}: finite, launches {qdm_counts}, "
          f"{api_s:.3f} s first call; first {CHECK_SITES} sites vs CPU port max abs diff {cpu_err:.3g}", flush=True)
    del scen

    # 4d. signs of zero (ROADMAP C29): pr-like rows with ±0.0 ties through
    # the headline core on the card, both kinds, and through nan_quantile
    # and vecquantiles on short rows (a sort in registers) and on the
    # core's group rows (a segmented radix sort), each held by bit pattern
    # (any NaN equal to any NaN) against the port's CPU result on the same
    # rows; the parent's unstable sort on the card is counted beside it
    zero_checks = c29_phase(dev, gi)
    print(f"[c29] every sign-of-zero check held: {zero_checks}", flush=True)

    # 4e. C31 through the public path: dayofyear + 31 QDM, kind="*", on
    # dry-day pr, K1 on tables with +inf holes, against the CPU port by bit pattern
    c31_counts = c31_phase(dev)
    print(f"[c31] the public kind='*' dayofyear adjusts held; K1 launches {c31_counts}", flush=True)

    # 4b. the same data with one group: the adjust's lookup is K2
    torch.cuda.synchronize()
    profiling.reset_counters()
    t0 = time.perf_counter()
    tscen = run_time_path(ref, hist, sim, t)
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    time_counts = profiling.counters("launch.")
    assert tscen.is_cuda and tuple(tscen.shape) == (N_SITES, 365 * N_YEARS), (tscen.device, tuple(tscen.shape))
    assert bool(torch.isfinite(tscen).all()), "group='time': non-finite output"
    assert time_counts["interp_table_2d"] >= 1, f"group='time' path launched K2 {time_counts['interp_table_2d']} times"
    want = run_time_path(*(torch.from_numpy(a[cut]) for a in (ref_np, hist_np, sim_np)), t)
    n_diff = int((tscen[cut].cpu() != want).sum())
    torch.testing.assert_close(tscen[cut].cpu(), want, **TOL)
    print(f"[main path] QDM group='time' train+adjust {tuple(tscen.shape)} f32 on {dev}: finite, launches {time_counts}, "
          f"{api_s:.3f} s first call; first {CHECK_SITES} sites vs CPU port: {n_diff} values differ, max abs diff "
          f"{_max_abs(tscen[cut].cpu(), want):.3g}", flush=True)
    del tscen

    # 4c. the device-copy cache: headline QDM train on numpy arrays, then
    # adjust twice on the same sim; the second uploads nothing
    _wrap.clear_device_cache()
    das = [_da(a, t, k) for a, k in ((ref_np, "ref"), (hist_np, "hist"), (sim_np, "sim"))]
    torch.cuda.synchronize()
    misses = [_wrap.misses]
    cqdm = xp.QuantileDeltaMapping.train(das[0], das[1], group="time.month", nquantiles=NQ, kind="+")
    misses.append(_wrap.misses)
    scens = []
    for _ in range(2):
        scens.append(cqdm.adjust(das[2], interp="linear").data)
        misses.append(_wrap.misses)
    torch.cuda.synchronize()
    uploads = np.diff(misses).tolist()
    assert uploads == [2, 1, 0], f"cache: uploads by train, adjust, adjust {uploads}"
    assert scens[0].is_cuda and torch.equal(scens[0], scens[1]), "cache: the second adjust's scen differs from the first"
    warm = _summary(_host_ms(lambda: cqdm.adjust(das[2], interp="linear"), cached=True))
    cold = _summary(_host_ms(lambda: cqdm.adjust(das[2], interp="linear")))
    held = sum(v.numel() * v.element_size() for v in _wrap._DEV_CACHE.values())
    print(f"[cache] QDM train then adjust twice on numpy {tuple(ref_np.shape)} f32: uploads {uploads} (train, adjust, adjust), the second scen "
          f"equal to the first; public adjust (host clock) with the cached sim {_fmt(warm)}, with the cache cleared before each call "
          f"{_fmt(cold)}; {len(_wrap._DEV_CACHE)} cached copies, {held / 2**30:.3f} GiB [{smi}]", flush=True)
    del cqdm, scens, das
    _wrap.clear_device_cache()

    # 5. heavy windowed EQM through the public API, then the window-5 path
    hcut = slice(0, HEAVY_CHECK)
    small = [torch.from_numpy(a[hcut]) for a in (href_np, hhist_np, hsim_np)]
    paths = {}
    for window in (HEAVY_WINDOW, SMALL_WINDOW):
        torch.cuda.synchronize()
        profiling.reset_counters()
        t0 = time.perf_counter()
        hscen = run_windowed_path(href, hhist, hsim, th, window)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = paths[window] = profiling.counters("launch.")
        assert hscen.is_cuda and tuple(hscen.shape) == (HEAVY_SITES, 365 * HEAVY_YEARS), (hscen.device, tuple(hscen.shape))
        assert bool(torch.isfinite(hscen).all()), f"window {window}: non-finite output"
        need = ("sort_rows_alternating", "build_levels", "fold_windows") if window >= 9 else ("sort_rows_alternating", "merged_window_rows")
        assert all(counts[k] >= 1 for k in need + ("interp_table_3d", "fma")), f"window {window}: launches {counts}"
        # one launch builds every level: one level build a fold
        assert counts["build_levels"] == counts["fold_windows"], f"window {window}: launches {counts}"
        with xp.set_options(selection_backend=False):  # the CPU's default engine is selection
            cpu = run_windowed_path(*small, th, window)
        torch.testing.assert_close(hscen[hcut].cpu(), cpu, **TOL)
        # the merge engine's static extraction rounds the type-7 arithmetic
        # in numpy, unfused, as the reference's merge engine does, and the
        # re-sort oracle fuses it as the reference's compiled oracle does
        # (ROADMAP C2): in float32 a top-tail quantile can move by an ulp of
        # the virtual index times the gap it interpolates, past 2e-6.  So
        # the oracle holds the card's merge path in float64 (1e-12, the CPU
        # tests' float64 tolerance), and float32 holds it to the CPU port
        small64 = [a.to(dev, torch.float64) for a in small]
        got64, oracle64 = run_windowed_path(*small64, th, window).cpu(), resort_oracle(*small64, th, window).cpu()
        torch.testing.assert_close(got64, oracle64, rtol=1e-12, atol=1e-12)
        oracle = resort_oracle(*(a.to(dev) for a in small), th, window).cpu()
        cpu_err, oracle_err = (float((hscen[hcut].cpu() - w).abs().max()) for w in (cpu, oracle))
        print(f"[heavy] EQM dayofyear window={window} train+adjust {tuple(hscen.shape)} f32 on {dev}: finite, launches {counts}, "
              f"{first_s:.3f} s first call; first {HEAVY_CHECK} sites vs the CPU port's merge path max abs diff {cpu_err:.3g} "
              f"(vs the f32 re-sort oracle {oracle_err:.3g}); in float64 vs the re-sort oracle {_max_abs(got64, oracle64):.3g}", flush=True)
        del hscen

    # 5b. the selection engine through the public call, on numpy inputs:
    # its gather mode first
    sel_counts, sel_scen = {}, {}
    with xp.set_options(selection_on_tpu=True, selection_mode="gather"):
        for tag, arrays, ncheck in (("finite", sel_np, SEL_CHECK), ("NaN-masked", sel_masked, SEL_NAN_CHECK)):
            torch.cuda.synchronize()
            profiling.reset_counters()
            t0 = time.perf_counter()
            sscen = run_windowed_path(*arrays, sth)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = sel_counts[tag] = profiling.counters("launch.")
            assert sscen.is_cuda and tuple(sscen.shape) == (SEL_SITES, 365 * HEAVY_YEARS), (sscen.device, tuple(sscen.shape))
            r_np, h_np, s_np = arrays
            want_nan = np.isnan(s_np) | np.isnan(r_np).all(-1)[:, None] | np.isnan(h_np).all(-1)[:, None]
            assert torch.equal(torch.isnan(sscen).cpu(), torch.from_numpy(want_nan)), f"selection {tag}: NaN where the data has none"
            assert counts["sort_rows_with_payload"] >= 1 and counts["interp_table_3d"] >= 1, f"selection {tag}: launches {counts}"
            assert all(counts[k] == 0 for k in merge.launches), f"selection {tag}: a merge kernel ran: {counts}"
            got = sscen[:ncheck].cpu()
            small_np = [a[:ncheck] for a in arrays]
            with xp.set_options(device="cpu"):
                cpu = run_windowed_path(*small_np, sth)
            oracle = resort_oracle(*(torch.from_numpy(a).to(dev) for a in small_np), sth).cpu()
            n_cpu, n_oracle = (int((~_nan_equal(got, w)).sum()) for w in (cpu, oracle))
            torch.testing.assert_close(got, cpu, equal_nan=True, **TOL)
            torch.testing.assert_close(got, oracle, equal_nan=True, **TOL)
            print(f"[selection] EQM dayofyear window={HEAVY_WINDOW} ({tag}) train+adjust on numpy {tuple(sscen.shape)} f32 -> {sscen.device}: "
                  f"NaN exactly where the data is missing, launches {counts}, {first_s:.3f} s first call; first {ncheck} sites: "
                  f"{n_cpu} values differ from the CPU port (max abs diff {_max_abs(got, cpu):.3g}), {n_oracle} from the re-sort "
                  f"oracle (max abs diff {_max_abs(got, oracle):.3g})", flush=True)
            sel_scen[tag] = sscen
    # the same calls in the default mode, which on CUDA is emit, as the
    # reference resolves "auto" off the CPU, and finite again under
    # selection_mode="emit": the scen of the gather engine, K7, the emission
    # kernel and K1, no merge kernel
    emit_counts = {}
    for mode, tag, arrays in ((None, "finite", sel_np), (None, "NaN-masked", sel_masked), ("emit", "finite", sel_np)):
        with xp.set_options(selection_on_tpu=True, **({} if mode is None else {"selection_mode": mode})):
            torch.cuda.synchronize()
            profiling.reset_counters()
            t0 = time.perf_counter()
            escen = run_windowed_path(*arrays, sth)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        counts = profiling.counters("launch.")
        if mode is None:
            emit_counts[tag] = counts
        r_np, h_np, s_np = arrays
        want_nan = np.isnan(s_np) | np.isnan(r_np).all(-1)[:, None] | np.isnan(h_np).all(-1)[:, None]
        assert escen.is_cuda and torch.equal(torch.isnan(escen).cpu(), torch.from_numpy(want_nan)), f"emit {tag}: NaN where the data has none"
        assert all(counts[k] >= 1 for k in ("sort_rows_with_payload", "emit", "interp_table_3d")), f"emit {tag}: launches {counts}"
        assert all(counts[k] == 0 for k in merge.launches), f"emit {tag}: a merge kernel ran: {counts}"
        n_diff = int((~_nan_equal(escen, sel_scen[tag])).sum())
        assert n_diff == 0, f"emit {tag}: {n_diff} values differ from the gather engine's scen"
        print(f"[selection] EQM dayofyear window={HEAVY_WINDOW} ({tag}) train+adjust on numpy {tuple(escen.shape)} f32 -> {escen.device}, "
              f"selection_mode={'default (auto)' if mode is None else repr(mode)}: NaN exactly where the data is missing, "
              f"launches {counts}, {first_s:.3f} s first call; scen == the gather engine's on all {escen.numel()} values [{smi}]", flush=True)
        del escen
    del sel_scen

    _wrap.clear_device_cache()   # no cached copies of the phases before in what is held
    # 5c. the multivariate schemes through the public calls, on numpy inputs
    mb_counts, mb_train_counts = {}, {}
    for tag, cfg in (("MBCn-a", MBCN_A), ("MBCn-b", MBCN_B)):
        mref, mhist, msim = mbcn_problem(cfg["sites"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        profiling.reset_counters()
        t0 = time.perf_counter()
        obj = xp.MBCn.train(mref, mhist, base_kws={"nquantiles": cfg["nq"], "group": xp.Grouper(*cfg["group"])}, n_iter=MBCN_ITERS, n_escore=-1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        mb_train_counts[tag] = profiling.counters("launch.")
        n_chunks = mbcn_chunks(cfg["sites"], cfg["group"])[0]
        assert mb_train_counts[tag]["interp_table_2d"] == n_chunks * MBCN_ITERS, f"{tag} train: launches {mb_train_counts[tag]}"
        scen = obj.adjust(msim, mref, mhist)
        torch.cuda.synchronize()
        both_s = time.perf_counter() - t0
        counts = mb_counts[tag] = profiling.counters("launch.")
        peak = torch.cuda.max_memory_allocated(dev)
        line = check_mbcn(tag, cfg, mref, mhist, msim, obj, scen, counts)
        print(f"[multivariate] {tag} MBCn train+adjust on numpy {tuple(scen.data.shape)} f32 -> {scen.data.device}, group {cfg['group']}, nq {cfg['nq']}, "
              f"{MBCN_ITERS} rotations: train {train_s:.3f} s, train+adjust {both_s:.3f} s (first call, host clock), peak {peak / 2**30:.3f} GiB allocated "
              f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before it); {line}", flush=True)
        del obj, scen
    # a small NpdfTransform with a monthly QDM base: the grouped nearest lookup (K1), the energy score on all points
    tn = xp.date_range("1981-01-01", periods=NPDF_DAYS, freq="D", calendar="noleap")
    nrng = np.random.default_rng(5)

    def npdf_da(mu):
        x = nrng.normal(mu, 3, (NPDF_SITES, MBCN_VARS, NPDF_DAYS)).astype(np.float32)
        x[:, 1] += 0.5 * x[:, 0]
        return xp.DataArray(x, ("site", "multivar", "time"), {"time": tn, "multivar": np.array(["a", "b", "c"]), "site": np.arange(NPDF_SITES)}, {"units": ""}, "data")

    nref, nhist, nsim = npdf_da(10), npdf_da(12), npdf_da(13)
    nrot = rand_rot_matrix(MBCN_VARS, num=NPDF_ITERS, dtype=torch.float32, device=dev)     # the stream's generator on the card
    npdf_kw = dict(base_kws={"nquantiles": 20, "group": "time.month"}, n_iter=NPDF_ITERS, n_escore=0)
    torch.cuda.synchronize()
    profiling.reset_counters()
    with xp.set_options(extra_output=True):
        nout = xp.NpdfTransform.adjust(nref, nhist, nsim, rot_matrices=nrot, **npdf_kw)
        torch.cuda.synchronize()
        npdf_counts = profiling.counters("launch.")
        with xp.set_options(device="cpu"):
            ncpu = xp.NpdfTransform.adjust(nref, nhist, nsim, rot_matrices=nrot.cpu(), **npdf_kw)
    assert nout["scen"].data.is_cuda and bool(torch.isfinite(nout["scen"].data).all()) and bool(torch.isfinite(nout["escores"].data).all())
    assert tuple(nout["escores"].data.shape) == (NPDF_SITES, NPDF_ITERS)
    # hist and sim, once a rotation, through the 3-D lookup on partition rows
    assert npdf_counts["interp_table_3d"] == 2 * NPDF_ITERS and npdf_counts["interp_table_2d"] == 0, f"NpdfTransform: launches {npdf_counts}"
    # [V, site, T]: a site whose float32 state parted from the CPU port's is
    # off everywhere, the others agree but for a few values on a node boundary
    close = ((nout["scen"].data.cpu() - ncpu["scen"].data).abs() <= 1e-4).float().mean(dim=(0, 2))
    good = close >= 0.99
    assert int(good.sum()) >= NPDF_SITES - 2, f"NpdfTransform: share of values within 1e-4 of the CPU port, by site: {close.tolist()}"
    torch.testing.assert_close(nout["escores"].data.cpu()[good], ncpu["escores"].data[good], rtol=5e-3, atol=1e-4)
    print(f"[multivariate] NpdfTransform {NPDF_SITES} sites x {MBCN_VARS} variables x {NPDF_DAYS} days, monthly QDM base, nearest, {NPDF_ITERS} rotations, "
          f"n_escore=0: finite, launches {npdf_counts}; {int(good.sum())} of {NPDF_SITES} sites have 99 % of their values within 1e-4 of the CPU port "
          f"(least share {float(close.min()):.4f}); escores of site 0: {[round(float(e), 4) for e in nout['escores'].data[0]]}", flush=True)
    del nout, ncpu

    # Scaling and LOCI on the headline data, monthly, linear (the fused group blend), against the CPU port
    sl_counts = {}
    for cls, kw, tol in (("Scaling", dict(kind="+"), TOL), ("LOCI", dict(thresh="9 K"), dict(rtol=2e-5, atol=2e-5))):
        torch.cuda.synchronize()
        profiling.reset_counters()
        trained = getattr(xp, cls).train(_da(ref_np, t, "ref"), _da(hist_np, t, "hist"), group="time.month", **kw)
        got = trained.adjust(_da(sim_np, t, "sim"), interp="linear").data
        torch.cuda.synchronize()
        sl_counts[cls] = profiling.counters("launch.")
        assert got.is_cuda and tuple(got.shape) == (N_SITES, 365 * N_YEARS) and bool(torch.isfinite(got).all()), f"{cls}: {got.device}, {tuple(got.shape)}"
        assert sl_counts[cls]["fma"] >= 1, f"{cls}: launches {sl_counts[cls]}"
        with xp.set_options(device="cpu"):
            want = getattr(xp, cls).train(_da(ref_np[cut], t, "ref"), _da(hist_np[cut], t, "hist"), group="time.month", **kw).adjust(_da(sim_np[cut], t, "sim"), interp="linear").data
        torch.testing.assert_close(got[cut].cpu(), want, **tol)
        print(f"[multivariate] {cls} monthly train+adjust(linear) on numpy {tuple(got.shape)} f32 -> {got.device}: finite, launches fma {sl_counts[cls]['fma']}; "
              f"first {CHECK_SITES} sites vs the CPU port max abs diff {_max_abs(got[cut].cpu(), want):.3g}", flush=True)
        del got, trained

    _wrap.clear_device_cache()   # no cached copies of the phases before in what is held
    # 5d. DQM through the public calls on numpy inputs: BASELINE config 2 (pr,
    # multiplicative, monthly, dry-day preprocessing, LOESS on the FFT core),
    # then dayofyear + 31 on the heavy data (the merge engine, a polynomial
    # trend a windowed group)
    tp, (pref_np, phist_np, psim_np) = pr_problem(PR_SITES, PR_YEARS)
    dqm_runs = {}
    for tag, train, adjust, data, t_run in (
        ("config 2", config2_train, config2_adjust, (pref_np, phist_np, psim_np), tp),
        ("dayofyear+31", dqm_doy_train, dqm_doy_adjust, (href_np, hhist_np, hsim_np), th),
    ):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        profiling.reset_counters()
        t0 = time.perf_counter()
        trained = train(data[0], data[1], t_run)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        out = adjust(trained, data[2], t_run)
        torch.cuda.synchronize()
        both_s = time.perf_counter() - t0
        counts = profiling.counters("launch.")
        peak = torch.cuda.max_memory_allocated(dev)
        scen = out["scen"].data
        S = data[0].shape[0]
        assert scen.is_cuda and scen.dtype == torch.float32 and tuple(scen.shape) == (S, data[0].shape[1]), (scen.device, scen.dtype, tuple(scen.shape))
        assert bool(torch.isfinite(scen).all()) and bool(torch.isfinite(out["trend"].data).all()), f"DQM {tag}: non-finite output"
        others = {k: n for k, n in counts.items() if n and k not in ("interp_table_3d", "fma") + tuple(merge.launches)}
        assert not others, f"DQM {tag}: another kernel of the port ran: {counts}"
        if tag == "config 2":
            # one K1 launch (nearest, the monthly partition's long rows) and
            # nothing else: every multiply-add of this path is eager in the
            # JAX package, so none is fused (ROADMAP C11)
            assert counts["interp_table_3d"] == 1 and counts["fma"] == 0 and not any(counts[k] for k in merge.launches), f"DQM {tag}: launches {counts}"
            with SeededDraws(7):
                got = config2_adjust(config2_train(pref_np, phist_np, tp), psim_np, tp)
            with SeededDraws(7), xp.set_options(device="cpu"):
                want = config2_adjust(config2_train(*(a[:PR_CHECK] for a in (pref_np, phist_np)), tp), psim_np[:PR_CHECK], tp)
        else:
            assert all(counts[k] >= 1 for k in ("sort_rows_alternating", "build_levels", "fold_windows", "fma", "interp_table_3d")), f"DQM {tag}: launches {counts}"
            assert counts["build_levels"] == counts["fold_windows"], f"DQM {tag}: launches {counts}"
            got = out
            with xp.set_options(device="cpu", selection_backend=False):   # the CPU's default engine is selection
                want = dqm_doy_adjust(dqm_doy_train(*(a[:PR_CHECK] for a in (href_np, hhist_np)), th), hsim_np[:PR_CHECK], th)
        cut4 = slice(0, PR_CHECK)
        trend_err = float(((got["trend"].data[cut4].cpu() - want["trend"].data).abs() / want["trend"].data.abs()).max())
        assert trend_err <= LOESS_RTOL, f"DQM {tag}: the trend differs from the CPU port's by {trend_err:.3g} (relative)"
        line = held_with_flips(f"DQM {tag}", got["scen"].data[cut4].cpu(), want["scen"].data)
        dqm_runs[tag] = dict(counts=counts, trained=trained, out=out)
        print(f"[dqm] {tag} train+adjust on numpy {tuple(scen.shape)} f32 -> {scen.device}: finite, launches {counts}; train {train_s:.3f} s, "
              f"train+adjust {both_s:.3f} s (first call, host clock), peak {peak / 2**30:.3f} GiB allocated ({(peak - base) / 2**30:.3f} GiB above "
              f"the {base / 2**30:.3f} GiB held before it); first {PR_CHECK} sites vs the CPU port (the same draws): trend max rel diff {trend_err:.3g}, "
              f"scen: {line}", flush=True)
        del scen, out, got, want
    # the LOESS trend alone on the card against the CPU port at config 2's
    # width, interior and edges apart
    x_ord = np.asarray(tp.ordinal, dtype=np.float64)
    psim = torch.from_numpy(psim_np).to(dev)
    lo_card = loess_smoothing(psim, x_ord, **LOESS_KW).cpu()
    lo_cpu = loess_smoothing(torch.from_numpy(psim_np), x_ord, **LOESS_KW)
    n_t = psim_np.shape[1]
    edge = (2 * (int(LOESS_KW["f"] * n_t) // 2)) // 2 + 3
    parts = {"left edge": np.s_[:, :edge], "interior": np.s_[:, edge:-edge], "right edge": np.s_[:, -edge:]}
    lo_err = {k: float(((lo_card[sl] - lo_cpu[sl]).abs() / lo_cpu[sl].abs()).max()) for k, sl in parts.items()}
    assert max(lo_err.values()) <= LOESS_RTOL, f"LOESS on the card vs the CPU port: {lo_err}"
    print(f"[dqm] LoessDetrend trend alone {tuple(psim.shape)} f32 (f={LOESS_KW['f']}, {edge} edge points a side) on the card vs the CPU port, max rel diff: "
          + ", ".join(f"{k} {v:.3g}" for k, v in lo_err.items()), flush=True)
    del lo_card, lo_cpu

    _wrap.clear_device_cache()   # no cached copies of the phases before in what is held
    # 5e. the second-order and multivariate transforms through the public
    # calls: ExtremeValues on config 2's DQM scen, PrincipalComponents at 512
    # sites, OTC / dOTC at one site; each held against the CPU port and timed
    ours = ("interp_rows_kernel", "interp_bracketed_kernel", "fma_rows_kernel", "fma_strided_kernel", "sort_rows_warp_kernel", "sort_rows_alt_kernel", "build_levels_kernel", "fold_windows_kernel",
            "radix_tile_sort_kernel", "merge_pass_kernel", "emit_kernel")
    second_counts = second_order_phase(dev, ours, tp, (pref_np, phist_np, psim_np), dqm_runs["config 2"]["out"]["scen"].data)
    print(f"[second-order] launches by path (kernels launched at least once): {({p: {k: n for k, n in c.items() if n} for p, c in second_counts.items()})}", flush=True)

    _wrap.clear_device_cache()   # no cached copies of the phases before in what is held
    # 5f. BASELINE config 5: QDM adjust plus the validation suite on a
    # 2048-site tile, in blocks of 512 sites, held against the CPU port
    c5_counts = config5_phase(dev, ours)
    print(f"[config 5] QDM kernels' launches by block: {c5_counts}", flush=True)

    _wrap.clear_device_cache()   # no cached copies of the phases before in what is held
    # 5g. cubic interpolation, the moving-window adjustment, MBCn with pr's
    # preprocessing, the additive space, the spectral filter and the public
    # lookup, at full width, each held against the CPU port
    a7_counts = a7_phase(dev, smi)
    print(f"[a7] launches by item (kernels launched at least once): {({p: {k: n for k, n in c.items() if n} if 'train' not in c else c for p, c in a7_counts.items()})}", flush=True)

    _wrap.clear_device_cache()   # no cached copies of the phases before in what is held
    # 5h. the shell: the CLI's selftest, nbutils, base.map_groups and a
    # profiling trace of the heavy windowed EQM, each held against the CPU port
    shell_counts = shell_phase(smi, (th, href, hhist, hsim))
    print(f"[shell] the trace's launches (kernels launched at least once): {({k: n for k, n in shell_counts.items() if n})}", flush=True)

    _wrap.clear_device_cache()   # no cached copies of the phases before in what is held
    # 5i. the parallel layer under one NCCL rank (correctness only)
    parallel_walls = parallel_phase(dev, smi)
    print(f"[parallel] every hold passed; wall seconds {parallel_walls}", flush=True)

    _wrap.clear_device_cache()   # no cached copies of the phases before in what is held
    # 6. times
    q = torch.as_tensor(equally_spaced_nodes(NQ), dtype=torch.float32, device=dev)
    idx = [torch.as_tensor(a, device=dev) for a in (gi.gather_idx, gi.group_idx, gi.scatter_slot)]
    brackets = device_brackets(gi, "linear", dev)

    def qdm_step():
        return qdm_train_adjust_core(ref, hist, sim, *idx, brackets, q, kind="+", interp="linear", extrapolation="constant")

    fused = _summary(_time_ms(qdm_step))
    print(f"[time] fused qdm_train_adjust_core {N_SITES} sites x {N_YEARS} yr: {N_SITES * N_YEARS / (fused['median_ms'] / 1e3):,.0f} "
          f"gridpoint-years/s ({_fmt(fused)})", flush=True)

    # the same step before ROADMAP C29's repair (the parent's unstable value
    # sort bound in place of nan_quantile) and after it, in turns
    from xsdba_tpu_torch.models import _algos as algos

    def qdm_step_unstable():
        stable_quantile = algos.nan_quantile
        algos.nan_quantile = _unstable_nan_quantile
        try:
            return qdm_step()
        finally:
            algos.nan_quantile = stable_quantile

    c29_turns = _steps_in_turns({"unstable sort (before C29)": qdm_step_unstable, "stable sort": qdm_step}, reps=7)
    print(f"[time] fused QDM step in turns: before C29 (unstable value sort) {_fmt(c29_turns['unstable sort (before C29)'])}; "
          f"stable value sort {_fmt(c29_turns['stable sort'])} [{smi}]", flush=True)
    # phase 5h's timed: the host clock around each call and a synchronize on its output's device
    timed_s, _ = profiling.timed(qdm_step, reps=5, warmup=2)
    timed_ms = timed_s * 1e3
    assert timed_ms >= fused["min_ms"], f"timed's best {timed_ms:.3f} ms is below the least CUDA-event sample {fused['min_ms']:.3f} ms"
    print(f"[shell] profiling.timed of the fused QDM step: best of 5 {timed_ms:.3f} ms (host clock); CUDA events median {fused['median_ms']:.3f} ms, "
          f"least {fused['min_ms']:.3f} ms; timed - median {timed_ms - fused['median_ms']:+.3f} ms [{smi}]", flush=True)
    api = _summary(_host_ms(lambda: run_main_path(ref, hist, sim, t)))
    print(f"[time] public QDM train+adjust, same data (host clock): {_fmt(api)}", flush=True)

    hgi = xp.Grouper("time.dayofyear", window=HEAVY_WINDOW).indexes(th)
    hbrackets = device_brackets(hgi, "linear", dev)

    def heavy_step():
        return eqm_train_adjust_windowed(href, hhist, hsim, hgi.merge_plan, q, hbrackets, kind="+", interp="linear", extrapolation="constant", assume_finite=True)

    heavy = _summary(_time_ms(heavy_step))
    print(f"[time] fused eqm_train_adjust_windowed doy+{HEAVY_WINDOW} {HEAVY_SITES} sites x {HEAVY_YEARS} yr: "
          f"{HEAVY_SITES * HEAVY_YEARS / (heavy['median_ms'] / 1e3):,.0f} gridpoint-years/s ({_fmt(heavy)})", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    heavy_step()
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated(dev)
    hapi = _summary(_host_ms(lambda: run_windowed_path(href, hhist, hsim, th)))
    torch.cuda.reset_peak_memory_stats(dev)
    run_windowed_path(href, hhist, hsim, th)
    torch.cuda.synchronize()
    api_peak = torch.cuda.max_memory_allocated(dev)
    print(f"[time] public windowed EQM train+adjust, same data (host clock): {_fmt(hapi)}", flush=True)
    print(f"[memory] heavy fused step: peak {step_peak / 2**30:.3f} GiB allocated ({(step_peak - base) / 2**30:.3f} GiB above "
          f"the {base / 2**30:.3f} GiB held before it); public call: peak {api_peak / 2**30:.3f} GiB", flush=True)

    def sel_step():
        with xp.set_options(selection_on_tpu=True, selection_mode="gather"):
            return eqm_train_adjust_windowed(sref, shist, ssim, hgi.merge_plan, q, hbrackets, kind="+", interp="linear", extrapolation="constant")

    def merge_step():
        return eqm_train_adjust_windowed(sref, shist, ssim, hgi.merge_plan, q, hbrackets, kind="+", interp="linear", extrapolation="constant", assume_finite=True)

    def emit_step():  # the default mode: emit on CUDA
        with xp.set_options(selection_on_tpu=True):
            return eqm_train_adjust_windowed(sref, shist, ssim, hgi.merge_plan, q, hbrackets, kind="+", interp="linear", extrapolation="constant")

    engines = _steps_in_turns({"selection (gather)": sel_step, "selection (emit)": emit_step, "merge": merge_step})
    for label, summ in engines.items():
        print(f"[time] fused eqm_train_adjust_windowed doy+{HEAVY_WINDOW} {SEL_SITES} sites x {HEAVY_YEARS} yr, {label} engine: "
              f"{SEL_SITES * HEAVY_YEARS / (summ['median_ms'] / 1e3):,.0f} gridpoint-years/s ({_fmt(summ)}) [{smi}]", flush=True)
    torch.cuda.synchronize()
    emit_base = torch.cuda.memory_allocated(dev)
    _, emit_peak = _peak(dev, emit_step)
    print(f"[memory] emit fused step: peak {emit_peak / 2**30:.3f} GiB above the {emit_base / 2**30:.3f} GiB held before it "
          f"(limit {EMIT_PEAK / 2**30:.0f} GiB) [{smi}]", flush=True)
    assert emit_peak < EMIT_PEAK, f"the emit step's peak {emit_peak / 2**30:.3f} GiB above the held exceeds {EMIT_PEAK / 2**30:.0f} GiB"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sel_step()
    torch.cuda.synchronize()
    sel_peak = torch.cuda.max_memory_allocated(dev)
    for mode in ("gather", None):
        with xp.set_options(selection_on_tpu=True, **({} if mode is None else {"selection_mode": mode})):
            sapi = _summary(_host_ms(lambda: run_windowed_path(*sel_np, sth)))
        print(f"[time] public selection EQM train+adjust on numpy inputs, same data, selection_mode="
              f"{'default (auto: emit)' if mode is None else repr(mode)} (host clock): {_fmt(sapi)}", flush=True)
    print(f"[memory] selection fused step: peak {sel_peak / 2**30:.3f} GiB allocated ({(sel_peak - base) / 2**30:.3f} GiB above "
          f"the {base / 2**30:.3f} GiB held before it)", flush=True)


    # the multivariate train steps: one _mbcn_train_block of 20 rotations
    # (MBCn-a: its one block; MBCn-b: the first of its two chunks of blocks)
    for tag, cfg in (("MBCn-a", MBCN_A), ("MBCn-b", MBCN_B)):
        mref, mhist, _ = mbcn_problem(cfg["sites"])
        ra, ha = (torch.from_numpy(np.moveaxis(d.data, 1, 0).copy()).to(dev) for d in (mref, mhist))   # [V, site, T]
        chunk = mbcn_chunks(cfg["sites"], cfg["group"])[3]
        gidx = torch.as_tensor(xp.Grouper(*cfg["group"]).indexes(mref.coords["time"]).gather_idx[:chunk], device=dev)
        rotm = rand_rot_matrix(MBCN_VARS, num=MBCN_ITERS, dtype=torch.float32, device=dev)
        qm = torch.as_tensor(equally_spaced_nodes(cfg["nq"]).astype(np.float32), device=dev)

        def mbcn_step():
            return mbcn._mbcn_train_block(ra, ha, gidx, rotm, qm, interp="nearest", extrap="constant", n_escore=-1)

        summ = _summary(_time_ms(mbcn_step))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        mbcn_step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[time] {tag} _mbcn_train_block {cfg['sites']} sites x {MBCN_VARS} variables x {MBCN_YEARS} yr, {tuple(gidx.shape)} block rows, nq {cfg['nq']}, "
              f"{MBCN_ITERS} rotations: {MBCN_ITERS / (summ['median_ms'] / 1e3):,.1f} training iterations/s ({_fmt(summ)}); peak {peak / 2**30:.3f} GiB allocated "
              f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before it)", flush=True)
        _profile(f"one {tag} train step ({MBCN_ITERS} rotations)", mbcn_step, ours)
        del ra, ha, gidx, mref, mhist
    torch.cuda.empty_cache()

    # the DQM steps (CUDA events): config 2's train (jitter, frequency
    # adaptation, normalized quantiles of the gathered months) and the
    # windowed train (merge engine), each adjust's quantile-mapping step on
    # its detrended series, the LOESS and polynomial trends alone; the public
    # calls (host clock) and their peak memory; config 2's adjust profiled
    pref, phist = (torch.from_numpy(a).to(dev) for a in (pref_np, phist_np))
    gim = xp.Grouper("time.month").indexes(tp)
    gidx_m = torch.as_tensor(gim.gather_idx, device=dev)
    c2 = dqm_runs["config 2"]
    doy = dqm_runs["dayofyear+31"]

    def c2_train_step():
        h = processing._jitter_core(phist, 0.01, None, None)
        refg = gather_groups(pref, gidx_m)
        histg = processing._adapt_freq_grouped(refg, gather_groups(h, gidx_m), 1.0)[0]
        return dqm_train_core(refg, histg, q, kind="*")

    def doy_train_step():
        return dqm_train_windowed(href, hhist, hgi.merge_plan, q, kind="+")

    def qm_step_of(run, sim_t, gi_run, kind):
        tables = [torch.as_tensor(run["trained"].ds[k].data, device=dev) for k in ("hist_q", "af", "scaling")]
        det = _scaled(sim_t, tables[2], gi_run, "nearest", kind)
        det = det / run["out"]["trend"].data if kind == "*" else det - run["out"]["trend"].data
        brk = device_brackets(gi_run, "nearest", dev)
        return lambda: qm_adjust_core(det, tables[0], tables[1], brk, kind=kind, interp="nearest", extrapolation="constant", tables_compact=True)

    hgroup = [torch.as_tensor(a, device=dev) for a in (hgi.gather_idx, hgi.group_idx, hgi.scatter_slot)]
    x_h = np.asarray(th.ordinal, dtype=np.float64)
    dqm_steps = {
        "config 2 train (jitter + adapt_freq + dqm_train_core)": (c2_train_step, PR_SITES),
        "config 2 adjust's QM step (qm_adjust_core, nearest)": (qm_step_of(c2, psim, gim, "*"), PR_SITES),
        "dayofyear+31 train (dqm_train_windowed)": (doy_train_step, HEAVY_SITES),
        "dayofyear+31 adjust's QM step (qm_adjust_core, nearest)": (qm_step_of(doy, hsim, hgi, "+"), HEAVY_SITES),
        "LOESS trend alone (loess_smoothing, FFT core)": (lambda: loess_smoothing(psim, x_ord, **LOESS_KW), PR_SITES),
        "PolyDetrend trend alone (grouped_polyfit_trend, degree 1, doy+31)": (lambda: grouped_polyfit_trend(hsim, x_h, *hgroup, degree=1), HEAVY_SITES),
    }
    for label, (step, sites) in dqm_steps.items():
        summ = _summary(_time_ms(step))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[time] DQM {label}, {sites} sites x {N_YEARS} yr: {sites * N_YEARS / (summ['median_ms'] / 1e3):,.0f} gridpoint-years/s ({_fmt(summ)}); "
              f"peak {(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before it", flush=True)
    for tag, train, adjust, data, t_run in (
        ("config 2", config2_train, config2_adjust, (pref_np, phist_np, psim_np), tp),
        ("dayofyear+31", dqm_doy_train, dqm_doy_adjust, (href_np, hhist_np, hsim_np), th),
    ):
        trained = dqm_runs[tag]["trained"]
        tr = _summary(_host_ms(lambda: train(data[0], data[1], t_run)))
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ad = _summary(_host_ms(lambda: adjust(trained, data[2], t_run)))
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[time] public DQM {tag} on numpy inputs (host clock): train {_fmt(tr)}; adjust {_fmt(ad)}; adjust's peak {(peak - base) / 2**30:.3f} GiB "
              f"above the {base / 2**30:.3f} GiB held", flush=True)
    _profile("config 2's public adjust", lambda: config2_adjust(c2["trained"], psim_np, tp), ours)
    _profile("config 2's train step", c2_train_step, ours)
    _profile("dayofyear+31 DQM train step", doy_train_step, ours)
    for label in ("LOESS trend alone (loess_smoothing, FFT core)", "PolyDetrend trend alone (grouped_polyfit_trend, degree 1, doy+31)"):
        _profile(label, dqm_steps[label][0], ours)
    del pref, phist, psim, gidx_m, hgroup
    torch.cuda.empty_cache()

    kb = dict(batch=KERNEL_BATCH)
    times = {"K1": _in_turns(lookup_short, lookup_short_twin, **kb), "K2": _in_turns(lookup2, lookup2_twin, **kb),
             "bracketed": _in_turns(bracketed, bracketed_twin, **kb)}
    # the heavy extraction's lerp, on the operands phase 3 held to the twin
    times["fma"] = _in_turns(lambda: fma_kernel.fma(fa, fb, fc), lambda: fma_kernel.fma_reference(fa, fb, fc), **kb)
    times["K7"] = _in_turns(lambda: sort.sort_rows_with_payload(key7, lab7), lambda: sort.sort_rows_with_payload_reference(key7, lab7), **kb)
    # the emission at the selection path's site chunk; its twin takes seconds, so 3 samples
    times["emit"] = _in_turns(lambda: emit_kernel.emit(*eops), lambda: emit_kernel.emit_reference(*eops), reps=3, **kb)
    times["K3"] = _in_turns(lambda: merge.sort_rows_alternating(slab), lambda: merge.sort_rows_alternating_reference(slab), **kb)
    times["K5"] = _in_turns(lambda: merge.build_levels(ordered, L), lambda: merge.build_levels_reference(ordered, L), **kb)
    width = HEAVY_WINDOW * ymax
    times["K6"] = _in_turns(
        lambda: merge.fold_windows(ordered, levels, HEAVY_WINDOW, G, ymax=ymax),
        lambda: merge.fold_windows_reference(ordered, levels, HEAVY_WINDOW, G, width), **kb,
    )
    times["K4"] = _in_turns(
        lambda: merge.merged_window_rows(ordered5, SMALL_WINDOW, G, ymax=ymax),
        lambda: merge.merged_window_rows_reference(ordered5, SMALL_WINDOW, G, SMALL_WINDOW * ymax), **kb,
    )
    if merge_others:
        merge_against(smi, merge_others, slab, L, G, ymax, ordered5)
    # the nearest method: K1 on the windowed adjust's rows (its linear row's inputs), K2 on MBCn-b's ranks
    times["K1 nearest"] = _in_turns(lambda: interp_kernel.interp_table_3d(vh, xsh, ysh, nvh, "nearest"),
                                    lambda: interp_kernel.interp_table_3d_reference(vh, xsh, ysh, nvh, "nearest"), **kb)
    times["K2 nearest"] = _in_turns(lambda: interp_kernel.interp_table_2d(*rank_b, "nearest"), lambda: interp_kernel.interp_table_2d_reference(*rank_b, "nearest"), **kb)
    # config 2's adjust: nearest on the monthly partition's long rows
    times["K1 nearest (long rows)"] = _in_turns(lambda: interp_kernel.interp_table_3d(v, xs, ys, nv, "nearest"),
                                                lambda: interp_kernel.interp_table_3d_reference(v, xs, ys, nv, "nearest"), **kb)
    shapes = {"K1 nearest (long rows)": f"{tuple(v.shape)} (config 2's monthly partition)", "K1 nearest": tuple(vh.shape), "K2 nearest": f"{tuple(rank_b[0].shape)}, nq {MBCN_B['nq']} (MBCn-b's ranks)", "K1": tuple(vh.shape), "K2": tuple(v2.shape), "bracketed": tuple(bargs[0].shape), "fma": f"{tuple(fa.shape)} * {tuple(fb.shape)}", "K3": tuple(slab.shape), "K5": tuple(ordered.shape), "K6": tuple(ordered.shape),
              "K4": tuple(ordered5.shape), "K7": tuple(key7.shape),
              "emit": f"{tuple(eops[0].shape)}, {int(plan.fast_mask.shape[0])} groups, nq {NQ} (one site chunk of the selection path)"}
    for k, (kern, twin) in times.items():
        print(f"[time] {k} {KERNELS[k]['name']} {shapes[k]}: kernel {_fmt(kern)}; plain twin {_fmt(twin)}", flush=True)
    # K1 on tables with +inf holes (ROADMAP C31: such a row is ranked by
    # value at staging) beside the same values on ordered tables, in turns
    holey = _steps_in_turns({
        "linear, ordered tables": lookup_short,
        "linear, tables with +inf holes": lambda: interp_kernel.interp_table_3d(vh, hxsh, hysh, hnvh),
        "nearest, ordered tables": lambda: interp_kernel.interp_table_3d(vh, xsh, ysh, nvh, "nearest"),
        "nearest, tables with +inf holes": lambda: interp_kernel.interp_table_3d(vh, hxsh, hysh, hnvh, "nearest"),
    }, reps=7, batch=KERNEL_BATCH)
    for label, sm in holey.items():
        print(f"[time] K1 {label} {tuple(vh.shape)} nq {NQ}, in turns: kernel {_fmt(sm)} [{smi}]", flush=True)
    # the lookup on the partition route's long rows (the headline's shape
    # before the bracketed entry), fma on same-shape operands and in float64
    kern, twin = _in_turns(lookup, lookup_twin, **kb)
    print(f"[time] K1 long rows {tuple(v.shape)}: kernel {_fmt(kern)}; plain twin {_fmt(twin)}", flush=True)
    # nearest and linear on the same inputs: the headline rows, MBCn-a's and MBCn-b's ranks
    for label, args in ((f"K2 {tuple(v2.shape)} nq {NQ}", (v2, xs2, ys2, nv2)), (f"K2 MBCn-a ranks {tuple(rank_a[0].shape)} nq {MBCN_A['nq']}", rank_a),
                        (f"K2 MBCn-b ranks {tuple(rank_b[0].shape)} nq {MBCN_B['nq']}", rank_b)):
        near = _summary(_time_ms(lambda: interp_kernel.interp_table_2d(*args, "nearest"), batch=KERNEL_BATCH))
        lin = _summary(_time_ms(lambda: interp_kernel.interp_table_2d(*args), batch=KERNEL_BATCH))
        print(f"[time] {label}: nearest {_fmt(near)}; linear {_fmt(lin)}", flush=True)
    fb_full = fb.expand_as(fa).contiguous()
    kern, twin = _in_turns(lambda: fma_kernel.fma(fa, fb_full, fc), lambda: fma_kernel.fma_reference(fa, fb_full, fc), **kb)
    print(f"[time] fma same shape {tuple(fa.shape)} f32: kernel {_fmt(kern)}; plain twin {_fmt(twin)}", flush=True)
    fa64, fb64, fc64 = fa.double(), fb.double(), fc.double()
    kern, twin = _in_turns(lambda: fma_kernel.fma(fa64, fb64, fc64), lambda: fma_kernel.fma_reference(fa64, fb64, fc64), **kb)
    print(f"[time] fma {shapes['fma']} f64: kernel {_fmt(kern)}; plain twin {_fmt(twin)}", flush=True)
    del fb_full, fa64, fb64, fc64
    # K3's long-row variant (off the port's paths at production shapes)
    wide = widened(slab, 2048)
    kern, twin = _in_turns(lambda: merge.sort_rows_alternating(wide), lambda: merge.sort_rows_alternating_reference(wide), **kb)
    print(f"[time] K3 long-row variant {tuple(wide.shape)}: kernel {_fmt(kern)}; plain twin {_fmt(twin)}", flush=True)
    del wide

    # one PyTorch call computing each kernel's function, where there is one:
    # torch.sort of the same rows, torch.addcmul for fma, timed in turns with
    # the kernel (the lookups and the emission have none)
    folded = merge.fold_windows(ordered, levels, HEAVY_WINDOW, G, ymax=ymax)
    merged5 = merge.merged_window_rows(ordered5, SMALL_WINDOW, G, ymax=ymax)
    shuffle = lambda a: a[..., torch.randperm(a.shape[-1], device=dev)].contiguous()  # noqa: E731
    wins, wins5 = shuffle(folded), shuffle(merged5)
    runs = ordered.reshape(ordered.shape[0], -1, (1 << L) * ordered.shape[-1])
    library = {
        "K3": lambda: torch.sort(slab, dim=-1),
        "K5": lambda: torch.sort(runs, dim=-1),
        "K6": lambda: torch.sort(wins, dim=-1),
        "K4": lambda: torch.sort(wins5, dim=-1),
        "K7": lambda: torch.sort(key7, dim=-1, stable=True),
    }
    library_ms = {k: _summary(_time_ms(fn, **kb))["median_ms"] for k, fn in library.items()}
    # fma and torch.addcmul in turns on the heavy lerp's operands
    fma_turns = _steps_in_turns({"fma": lambda: fma_kernel.fma(fa, fb, fc), "addcmul": lambda: torch.addcmul(fc, fa, fb)},
                                reps=7, batch=KERNEL_BATCH)
    library_ms["fma"] = fma_turns["addcmul"]["median_ms"]
    print(f"[time] fma {shapes['fma']} f32 in turns with torch.addcmul: kernel {_fmt(fma_turns['fma'])}; torch.addcmul "
          f"{_fmt(fma_turns['addcmul'])}; kernel / addcmul {fma_turns['fma']['median_ms'] / library_ms['fma']:.3f} [{smi}]", flush=True)
    for k, ms in library_ms.items():
        print(f"[time] {k} library call {'torch.addcmul' if k == 'fma' else 'torch.sort'} {shapes[k]}: median {ms:.3f} ms", flush=True)
    del wins, wins5, runs

    # least time on the card: bytes read and written once, and the
    # comparisons of the function (n log2 n for a sort, one per merged value
    # and level, log2 of the runs for a k-way merge, log2 nq + 5 per lookup,
    # two lookups and the blend's 3 per bracketed value, 2 per fma)
    f4 = 4
    log2 = lambda n: max(float(np.log2(n)), 1.0)  # noqa: E731
    bv, bxs, _, bnv, bg0 = bargs[:5]
    bounds = {
        "K1": _bound(vh.numel() * 2 * f4 + xsh.numel() * 2 * f4 + nvh.numel() * 4, vh.numel() * (log2(NQ) + 5)),
        "bracketed": _bound(bv.numel() * 2 * f4 + bxs.numel() * 2 * f4 + bnv.numel() * 4 + bg0.numel() * 12, bv.numel() * (2 * (log2(NQ) + 5) + 3)),
        "fma": _bound((3 * fa.numel() + fb.numel()) * f4, 2 * fa.numel()),
        "K2": _bound(v2.numel() * 2 * f4 + xs2.numel() * 2 * f4 + nv2.numel() * 4, v2.numel() * (log2(NQ) + 5)),
        # nearest: the search and two comparisons in place of the division and the fused multiply-add
        "K1 nearest": _bound(vh.numel() * 2 * f4 + xsh.numel() * 2 * f4 + nvh.numel() * 4, vh.numel() * (log2(NQ) + 4)),
        "K2 nearest": _bound(rank_b[0].numel() * 2 * f4 + rank_b[1].numel() * 2 * f4 + rank_b[3].numel() * 4, rank_b[0].numel() * (log2(MBCN_B["nq"]) + 4)),
        "K1 nearest (long rows)": _bound(v.numel() * 2 * f4 + xs.numel() * 2 * f4 + nv.numel() * 4, v.numel() * (log2(NQ) + 4)),
        "K3": _bound(slab.numel() * 2 * f4, slab.numel() * log2(slab.shape[-1])),
        "K5": _bound((ordered.numel() + levels.numel()) * f4, levels.numel()),
        "K6": _bound((ordered.numel() + levels.numel() + folded.numel()) * f4, folded.numel() * log2(len(merge.dyadic_segments(0, HEAVY_WINDOW, 1 << L)))),
        "K4": _bound((ordered5.numel() + merged5.numel()) * f4, merged5.numel() * log2(SMALL_WINDOW)),
        "K7": _bound(key7.numel() * 8 + key7.shape[0] * sort.padded_length(key7.shape[1]) * 8,
                     key7.shape[0] * sort.padded_length(key7.shape[1]) * log2(sort.padded_length(key7.shape[1]))),
        # every value and label read once, the counts and ranks read, the
        # picks written; one operation a (member, group) pair, which is
        # what the function needs: an element of label (a, len) is in its
        # len groups alone, so the pairs are the valid counts n summed
        "emit": _bound(sum(a.numel() * a.element_size() for a in eops[:6]) + (2 * eops[3].numel() + eops[5].numel()) * f4,
                       int(eops[5].sum())),
    }
    del folded, merged5

    _profile("one fused QDM step", qdm_step, ours)
    _profile(f"one fused windowed EQM step (doy+{HEAVY_WINDOW})", heavy_step, ours)
    _profile(f"one fused selection EQM step (doy+{HEAVY_WINDOW}, {SEL_SITES} sites)", sel_step, ours)
    _profile(f"one fused emit EQM step (doy+{HEAVY_WINDOW}, {SEL_SITES} sites)", emit_step, ours)

    launches = {
        "K1": paths[HEAVY_WINDOW]["interp_table_3d"],
        "bracketed": qdm_counts["interp_bracketed"],
        "fma": paths[HEAVY_WINDOW]["fma"],
        "K2": time_counts["interp_table_2d"],
        "K3": paths[HEAVY_WINDOW]["sort_rows_alternating"],
        "K5": paths[HEAVY_WINDOW]["build_levels"],
        "K6": paths[HEAVY_WINDOW]["fold_windows"],
        "K4": paths[SMALL_WINDOW]["merged_window_rows"],
        "K7": sel_counts["finite"]["sort_rows_with_payload"],
        "K1 nearest": npdf_counts["interp_table_3d"],
        "K2 nearest": mb_counts["MBCn-b"]["interp_table_2d"],
        "K1 nearest (long rows)": dqm_runs["config 2"]["counts"]["interp_table_3d"],
        "emit": emit_counts["finite"]["emit"],
    }
    rows = [
        dict(KERNELS[k], launches=launches[k], max_abs_err=err[k], ms=times[k][0]["median_ms"], plain_ms=times[k][1]["median_ms"],
             bound_ms=bounds[k][0], bound_by=bounds[k][1], library_ms=library_ms.get(k))
        for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "bracketed", "fma", "K1 nearest", "K2 nearest", "K1 nearest (long rows)", "emit")
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
