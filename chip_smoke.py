#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`progressivecodec_tpu_torch`) on one
NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero without
printing a result:
  1. device: the card's name, the device count, nvidia-smi's name and
     power limit;
  2. build: nvcc builds the kernels for sm_90a from csrc/, one nvcc per
     source, all at once (registers and spills from -Xptxas -v);
  3. kernels vs their plain PyTorch twins on the card, bit for bit: the
     encode and decode scans at the flagship grid (P=1956 rows, K=512
     lanes) on random and on real-table inputs, plus a small stream coded
     on the CPU as reference; CUDA-event timings of kernel and twin, ns per
     row, and the decode wrapper's host floor (12 launches of 0 rows, 9
     passes); the decode edge cases (the widest Gaussian row alone, every
     lane renormalising in every row so the stream ring wraps, K in
     {32, 64, 1024}, stages of P=0 and P=1 rows, symbols drawn from each
     row's distribution, the batch-8 grid of 15,648 rows, the global-table
     path); then the PCT1-G decode (the grouped entry) on the
     flagship-table stages at (K, G) = (512, 4), (512, 16) and (512, 2) and
     on smaller stages at (32, 4), (1024, 2), (64, 64) and (96, 3), escapes
     included, and the decode launches' split into prologue and rows on
     those stages at G in {1, 2, 4, 16} (`scan_split`: device times of
     one-row and full launches queued behind a sleep kernel);
  4. the main paths at full width, 768x512 seeded images, seeded random
     weights, compress -> serialize -> deserialize -> decompress: the
     flagship ModelConfig() at q in {0, 5, 10} (batch 1) and q=10 (batch 8)
     and an 80x-normal latent that must take escapes; the same model in
     PCT1-G with groups=4 at q in {0, 10}, whose y_hat must equal the
     one-stream codec's; the reference CLI default ModelConfig(
     multiple_decoder=False, stack_prog=False) through the unrolled
     enhancement at q in {0, 10}; WACNN (name="cnn", N=192, M=320) at
     q=0.  Each decoded y_hat must equal the encoder's simulated y_hat bit
     for bit, with stream_ok, and the launch counters, zeroed before each
     round trip, must show one encode launch and one decode launch per
     stage, over every group, and 8 launches of g_s's transposed
     convolution (4 in compress with simulate, 4 in decompress) with no
     `fallback:deconv2d` (every round trip of phases 4, 5, 8 and 10 holds
     to these);
  5. REM, ModelConfig(name="rate") (N=192, M=640, unrolled, 3 checkpoint
     levels x 10 LatentRateReduction banks), with every bank's zero_out
     weight drawn from N(0, 0.02^2) (seed SEED + 5; zero at init, where
     the banks are the identity): round trips at q in {0.01, 0.25, 1.0, 10}
     and in PCT1-G with groups=4 at q=1.0; at q=1.0 the keep flags and the
     stream must differ from the identity model's (zero_out = 0); then
     the escalation cascade at q=10 (three checkpoint containers and the
     final one, each through the container bytes): every stream_ok, the
     decoder's anchors, y_hat and x_hat equal to the encoder's bit for bit,
     4 encode and 84 decode launches;
  6. the eval path on the flagship: `evaluate_codec` and
     `entropy_estimate_eval` over SyntheticKodak(n=2) at q in {0, 5, 10}
     (real bpp < estimated bpp * 1.25 + 0.3, JAX's own bound), with the
     launches of every round trip counted, then
     `cli.eval.main(["--synthetic", "--max-images", "1", "--qualities",
     "0,10"])` in this process;
  7. training: `cli.train.main` on the flagship ModelConfig() at
     TrainConfig() defaults (batch 16, patch 256, lr 1e-4, aux_lr 1e-3)
     with --synthetic --epochs 2 --steps-per-epoch 4 --eval-every 1, then a
     resume from ckpt_last to --epochs 3 (epoch 2, steps 8 -> 12), in a
     temporary directory: every logged loss finite, each epoch's
     train_loss, valid, test and real_codec records, no eval_error, and
     the encode and decode kernels launched during every real-codec eval
     (6 and 70 per epoch); `cli.eval.main(["--checkpoint", ckpt_last,
     "--synthetic", "--max-images", "2", "--qualities", "0,1,10"])` must
     give the trainer's last real bpp at every quality; one step split by
     CUDA events into forward, backward and optimisers; and one
     `make_train_step` on the card against the same step on the CPU (full
     width, batch 2, 128x128, the same weights and the same noise drawn on
     the CPU): loss and aux loss within rtol 1e-4, every gradient within
     ||dg|| / ||g|| <= 1e-3.  It prints ms per step, images/s, peak device
     memory, checkpoint bytes and save seconds;
  8. importance masks, rd_sweep and profiling, on the flagship with seeded
     weights and the 768x512 image of phase 4: `importance_map` (finite,
     >= 0, not all zero, CUDA-event ms; the same map at 256x256 on the card
     and on the CPU, ||d||/||m|| <= 1e-3, with the count of elements whose
     snapped sigma differs); `init_mask_estractor` (N=320) and 10 steps of
     `make_mask_train_step` at lr 1e-4 against `importance_target`, every
     loss finite and the last below the first; `predict_cust_map`, then a
     round trip at q=5 with that map on both sides (stream_ok, bit-exact
     y_hat, 1 encode and 12 decode launches, keep flags unlike the
     sigma-ranked codec's); `ImportanceMapDataset` over SyntheticKodak(n=2)
     at patch 256; `cli.rd_sweep.main(["--synthetic-kodak", "--image", "0",
     "--grid", "coarse", "--device", "cuda", ...])` in this process (12
     qualities, bpp non-decreasing, 12 encode and 143 decode launches);
     a recorded span around each, ending in a sync; a `device_trace` of
     one q=10 round trip that must name both rANS kernels; `count_flops` of
     `forward_single_quality` at q=10 and the MFU of its CUDA-event-timed
     run against the card's float32 peak, which must lie in (0, 1);
  9. parallel/ (`parallel/` of the port, on torch.distributed): two ranks
     spawned on the one card (gloo, a file store in a temporary directory;
     they load phase 2's kernels and build none), references computed here
     first.  9.1, the sharded coder: phase 3's 12 flagship-table stages at
     K=512, G=2 (kt=256) and three smaller stages at K=32, G=2 (kt=16, the
     encode kernel's padded block), escapes included: each rank's streams
     equal the single-process `encode_stages(..., groups=2)` byte for
     byte, the sharded decode gives the symbols exactly with stream_ok;
     CUDA-event ms of each rank's encode launch and decode launches, host
     ms of its gathers.  9.2, the tiled codec at 2048x1024
     (tools/bench_2k.py's size) on the flagship: tiled analysis within 1e-5
     (max|dy| / max|y|) of the full width; tiled_compress -> serialize ->
     deserialize -> tiled_decompress at q in {0, 10} with one stream and
     with a coder_mesh over the two ranks, stream_ok and y_hat bit-exact;
     each untiled stream decodes tiled, each tiled stream decodes untiled
     here; the bytes and symbols in which the tiled stream differs from
     the untiled one are printed, not required; wall ms of both.  9.3, the
     flagship train step at TrainConfig() defaults (batch 16, 256x256) on
     meshes (2, 1) and (1, 2) against one single-process step here on the
     same batch, weights and noise: loss within rtol 1e-4, every gradient
     within ||dg|| / ||g|| <= 1e-3; on (1, 2) each rank must hold half of
     every sharded leaf and all of the replicated ones; 3 more steps on
     (2, 1), losses finite, ms per step.  9.4, a one-rank NCCL group from
     `initialize_from_env`: `allreduce_metrics`, an all_reduce, and the
     sharded coder at G=1 on CUDA tensors.  Two ranks time-share the card:
     no time of phase 9 is a scaling number.  Any failure in a rank exits
     nonzero, and every process started is stopped;
 10. every lane count the JAX coder takes: the 12 flagship-table stages
     re-gridded as one stream at K in {1024, 2048, 4096, 8192, 16384} (one
     CTA; clusters of 8 CTAs; a cooperative grid of 16 CTAs; a spanning
     stream's CTAs read their words from global memory)
     and three smaller stages at K in {48, 1056, 4100}, each decode kernel
     against its twin bit for bit, values exact, stream_ok, CUDA-event ms
     and ns per row; PCT1-G groups of kt = 2048 and 1025 (staged); the row
     and the exchange split (`scan_split` of a stream spanning C CTAs of w
     lanes against C one-CTA groups of w lanes on the same rows); flagship round trips at K=2048 (batch 8, q=10), K=48 (batch
     1, q=5) and K=16384 (batch 8, q=10), each with stream_ok and y_hat
     bit-exact, the cluster and grid launches counted; then
     `tools.bench_coder` over K in {512, 1024, 2048, 4096}.
 11. the codec tools of `progressivecodec_tpu_torch/tools/` through their
     `main`: `profile_codec` in both modes (the flagship at 768x512, q=10,
     n=4; the per-phase table, calls per round trip checked, and in the trace
     every device event charged to a phase), `bench_2k` (2048x1024, n=4;
     the one-rank tiled stream must equal the untiled one), `rd_ladder` on
     phase 7's last checkpoint (coarse grid, 2 SyntheticKodak images),
     killed after 5 points and resumed (exactly the 7 missing points coded),
     `rem_flagship` on that checkpoint (10 bank steps, 2 images; identity at
     init, frozen base unchanged, banks moved), `rem_demo` (20 base and 20
     bank steps) and `bd_trajectory` on phase 7's metrics.jsonl; the
     launches of each tool, zeroed before it and read after it.
 12. g_s's transposed convolutions (`ops/deconv_cuda.deconv2d_s2k5`,
     csrc/deconv.cu) against cuDNN's `F.conv_transpose2d` with TF32 off, rel
     L2 <= 1e-5, at ragged sizes (both kernel instances) and at g_s's four
     layer shapes of 768x512 batch 1, 768x512 batch 8 and 2048x1024 batch 1;
     one `deconv` JSON line per layer shape: the kernel's CUDA-event ms, its
     float32 bound, the plain version's ms (`deconv2d_subpixel`) and cuDNN's
     as `library_ms`, the yardstick (the port never calls it there).
`python3 chip_smoke.py --deconv` runs only phase 12, after building its one
kernel.
`python3 chip_smoke.py --ab [--lanes K,...] OTHER_CHECKOUT...` runs only
`scan_split`, each checkout's own, on other checkouts of the repo and on
this one, in separate processes ordered others, this, this, others
reversed (`ab_split`): at the flagship's K=512 for G in {1, 2, 4, 16}, or
the single stream at each K given.

The last line is {"ok": true, "device": {...}}; the line before it is the
`kernels` JSON object, whose encode and decode entries carry
`train_eval_launches` (phase 7's real-codec evals), `cust_map_launches`
(phase 8's map-ranked round trip), `rd_sweep_launches`, `sharded_launches`
(the launches phase 9's ranks made) and `tools_launches` (phase 11's per
tool).  Each decode entry names the kernel entry it measures
(`rans_cuda.decode_entry`): "stream" (the flagship's K=512), "grouped"
(K=512, G=4, its launches from the groups=4 round trip), then the
spanning instances, "cluster" (timed at K=2048, its launches from the
K=2048 round trip) and "grid" (K=16384); every decode launch counts as
`launch:rans_decode_scan`.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
H, W = 512, 768
LANES = 512
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# H100 SXM 32-bit integer rate: 64 of each SM's 128 lanes take INT32 work,
# so half the data sheet's 67 TFLOP/s float32 rate.  Both scans are integer.
INT32_OPS_PER_S = 33.5e12


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |kernel - twin| over a tuple of integer outputs."""
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------


def flagship_stages(tables, row0, rng, batch=1, from_pmf=False):
    """Stages shaped like the flagship round trip at q>0: z (B*8*12*192
    symbols on the bottleneck rows), 10 base slices and one stacked
    enhancement stage (B*32*48*32 and 10x that, on the Gaussian rows),
    symbols drawn uniformly inside each row's support plus ~1% escapes.
    With `from_pmf`, each symbol is drawn from its row's own distribution
    instead (cum uniform, as for data the model predicts well) and there
    are no escapes."""
    sizes = [(batch * 8 * 12 * 192, "z", 1.0)] + [(batch * 32 * 48 * 32, "base", 1.0)] * 10
    sizes.append((batch * 10 * 32 * 48 * 32, "prog", 0.5))
    n_rows = tables.cdf.shape[0]
    stages = []
    for n, kind, keep_frac in sizes:
        if kind == "z":
            idx = np.tile(np.arange(192, dtype=np.int32), n // 192)
        else:
            idx = rng.integers(row0, n_rows, n).astype(np.int32)
        lo = tables.offset[idx].astype(np.int64)
        hi = lo + tables.max_symbol[idx]
        if from_pmf:
            # the symbol whose CDF range holds a uniform cum, kept in support
            cum = rng.integers(0, 1 << 16, n)
            sym = np.empty(n, np.int64)
            for r in np.unique(idx):
                at = idx == r
                row = tables.cdf[r, : tables.cdf_length[r] - 1]
                sym[at] = np.minimum(np.searchsorted(row, cum[at], side="right") - 1,
                                     tables.max_symbol[r])
            sym += lo
        else:
            sym = np.floor(lo + rng.random(n) * (hi - lo + 1)).astype(np.int64)
            esc = rng.random(n) < 0.01
            sym[esc] = hi[esc] + rng.integers(1, 1000, esc.sum())
        keep = rng.random(n) < keep_frac
        stages.append(tuple(torch.from_numpy(a) for a in
                            (sym.astype(np.int32), idx, keep)))
    return stages


def stage_rows(codec, n_stages):
    """CDF row range of each flagship stage: z on the bottleneck rows, the
    rest on the Gaussian rows."""
    r = codec.device_tables.offset.shape[0]
    return [(0, codec.gauss_row0)] + [(codec.gauss_row0, r)] * (n_stages - 1)


def flagship_tables(dev):
    """The flagship's coder tables without a model: a seeded
    EntropyBottleneck(N) and the Gaussian rows.  Returns (merged host
    tables, DeviceTables on `dev`, first Gaussian row).  It uses only
    interfaces every checkout of the port has, so the functions built on it
    run against any checkout's package, to compare two of them."""
    from progressivecodec_tpu_torch.coder import rans_device
    from progressivecodec_tpu_torch.coder.tables import merge_tables
    from progressivecodec_tpu_torch.config import ModelConfig
    from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck, build_bottleneck_tables
    from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables

    cfg = ModelConfig()
    eb = EntropyBottleneck(cfg.N, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(SEED))
    merged, starts = merge_tables(build_bottleneck_tables(eb.host_params()),
                                  build_gaussian_tables(cfg.scale_table.values()))
    return merged, rans_device.DeviceTables.from_tables(merged, dev), int(starts[1])


def decode_wrapper_floor(dev, passes=9, lanes=LANES):
    """The decode wrapper's host floor: the 12 decode launches of a round
    trip with no rows, so the kernel returns at once and the CUDA-event time
    is the host's.  Returns the ms for all 12 in each of `passes` passes, on
    `flagship_tables`."""
    from progressivecodec_tpu_torch.coder import rans_device

    _, t, _ = flagship_tables(dev)
    streams = torch.zeros((1, 2 * lanes), dtype=torch.int16, device=dev)
    dec0 = rans_device.decoder_init(streams, lanes)
    ig = torch.zeros((0, lanes), dtype=torch.int32, device=dev)
    kg = torch.zeros((0, lanes), dtype=torch.uint8, device=dev)

    def run():
        for _ in range(12):
            rans_device.decode_stage_scan(dec0, streams, ig, kg, t, lanes)

    return [cuda_time_ms(run, reps=20) for _ in range(passes)]


# ~10 ms at the H100's clocks: longer than the host takes to queue the
# launches timed behind it
SLEEP_CYCLES = 20_000_000


def queued_ms(fn, reps=7) -> float:
    """Median device ms of `fn`'s launches run back to back: each rep queues
    them behind a sleep kernel, so CUDA events see the device's time and not
    the host's launch cost (the decode wrapper's ~40 us per launch is more
    than a one-row launch takes on the card).  Fails if the host took longer
    to queue them than the sleep lasted."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    times = []
    for _ in range(reps):
        ev[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        torch.cuda.synchronize()
        sleep_ms = ev[0].elapsed_time(ev[1])
        require(host_ms < sleep_ms, f"queueing took {host_ms:.2f} ms, the sleep only {sleep_ms:.2f} ms")
        times.append(ev[1].elapsed_time(ev[2]))
    return sorted(times)[reps // 2]


def scan_split(tables, t, row0, dev, groups=(1, 2, 4, 16), lanes=LANES):
    """The decode launches' split into prologue and rows, on the 12
    flagship-table stages (seed SEED + 7, as the grouped flagship case) at
    K=`lanes`: for each G (1: the one-stream entry, else the grouped one,
    `rans_cuda.decode_entry`) the device ms of the 12 stages' zero-row launches (the launch: the
    kernel returns before its prologue), one-row launches (the launch, the
    prologue and one row) and full launches, each by `queued_ms` with every
    stage's input state precomputed, and the ms of the 12 stages as a
    dependent chain (`cuda_time_ms`, host included, as the `kernels`
    line's ms).  Returns {G: dict}: ns_per_row_net is (full - one-row) over
    the rows past each stage's first, prologue_us the one-row launch less
    the zero-row launch and one such row, per stage."""
    from progressivecodec_tpu_torch.coder import rans_cuda, rans_device

    stages = [tuple(a.to(dev) for a in s)
              for s in flagship_stages(tables, row0, np.random.default_rng(SEED + 7))]
    rows_of = [(0, row0)] + [(row0, t.offset.shape[0])] * (len(stages) - 1)
    grids = [(rans_device._pad_to_grid(s_idx, lanes), rans_device._pad_to_grid(s_keep.to(torch.uint8), lanes))
             for _, s_idx, s_keep in stages]
    n_rows = sum(ig.shape[0] for ig, _ in grids)
    cluster_of = getattr(rans_cuda, "decode_cluster", None)  # None: a checkout without clusters
    out = {}
    for g in groups:
        streams, n_words, _, _ = rans_device.encode_stages(stages, t, lanes, g)
        if g == 1:
            streams = streams[:, : int(n_words)]
        dec = rans_device.decoder_init(streams, lanes)
        state = (dec.states, dec.offsets)

        def launch(s, o, ig, kg, rows, streams=streams):
            return rans_cuda.rans_decode_scan(s, o, streams, ig, kg, t.dec_sf, t.compact, rows)
        ins = []
        for (ig, kg), rows in zip(grids, rows_of):
            ins.append(state)
            state = launch(*state, ig, kg, rows)[:2]
        torch.cuda.synchronize()
        require(torch.equal(state[1].cpu().reshape(-1), n_words.cpu().to(torch.int32).reshape(-1)),
                f"split G={g}: the decoder did not consume every sub-stream")

        def part(n):
            for (s, o), (ig, kg), rows in zip(ins, grids, rows_of):
                launch(s, o, ig[:n], kg[:n], rows)

        def full():
            for (s, o), (ig, kg), rows in zip(ins, grids, rows_of):
                launch(s, o, ig, kg, rows)

        def chain():
            s, o = ins[0]
            for (ig, kg), rows in zip(grids, rows_of):
                s, o, _ = launch(s, o, ig, kg, rows)

        zero_ms, one_ms, full_ms = queued_ms(lambda: part(0)), queued_ms(lambda: part(1)), queued_ms(full)
        row_ns = 1e6 * (full_ms - one_ms) / (n_rows - len(grids))
        kt = lanes // g
        plan = rans_cuda.plan_decode(t.compact, rows_of[-1], rans_cuda.warp_lanes(kt), rans_cuda._smem_optin(0))
        ctas, grid = getattr(plan, "ctas", 1), getattr(plan, "grid", False)
        cluster = (None if grid else ctas) if ctas > 1 else cluster_of(g) if cluster_of and g > 1 else None
        out[g] = dict(kt=kt, cluster=cluster, ctas=ctas,
                      cta_lanes=plan.cta_lanes if ctas > 1 else rans_cuda.warp_lanes(kt),
                      route="grid" if grid else "cluster" if ctas > 1 else "one CTA",
                      smem_bytes=plan.smem_bytes, rows=n_rows, zero_row_ms=zero_ms, one_row_ms=one_ms,
                      full_ms=full_ms, chain_ms=cuda_time_ms(chain, reps=10), ns_per_row_net=row_ns,
                      prologue_us=1e3 * (one_ms - zero_ms) / len(grids) - 1e-3 * row_ns)
    return out


def log_split(split, label="") -> None:
    for g, r in split.items():
        span = (f", {r['ctas']} CTAs of {r['cta_lanes']} as a {r['route']}" if r.get("ctas", 1) > 1 else "")
        log(f"  decode split{label} G={g} (kt={r['kt']}{span}, cluster {r['cluster']}, {r['smem_bytes']} B shared "
            f"memory per CTA), 12 flagship-table stages, P={r['rows']}: zero-row launches {r['zero_row_ms']:.4f} "
            f"ms, one-row {r['one_row_ms']:.4f} ms, full {r['full_ms']:.4f} ms (device, queued): prologue "
            f"{r['prologue_us']:.2f} us per stage, {r['ns_per_row_net']:.1f} ns per row net of it; as a chain "
            f"{r['chain_ms']:.4f} ms")


def decode_bound(t, rows_of, cells, consumed, lanes, groups=1):
    """(bound ms, bound_by) of a decode over `cells` cells: idx, keep and
    cums per cell, each stage's compact table once, the payload words
    consumed, each stage's states and offsets in and out, at 3.35 TB/s,
    against ~12 INT32 operations per cell."""
    from progressivecodec_tpu_torch.coder import rans_cuda

    table_bytes = 0
    for rows in rows_of:
        plan = rans_cuda.plan_decode(t.compact, rows, lanes // groups, rans_cuda._smem_optin(0))
        table_bytes += 2 * plan.span_len + 2 * plan.nrows * plan.bucket_stride + 8 * plan.nrows
    dec_bytes = cells * (4 + 1 + 4) + table_bytes + consumed * 2 + len(rows_of) * (8 * lanes + 8 * groups)
    b, o = dec_bytes / MEM_BYTES_PER_S, cells * 12 / INT32_OPS_PER_S
    return 1e3 * max(b, o), "bytes" if b >= o else "operations"


def check_kernels(codec, dev):
    """Phase 3: each kernel against its plain twin, bit for bit; timings."""
    from progressivecodec_tpu_torch.coder import rans_cuda, rans_device

    t = codec.device_tables
    results = {}
    rng = np.random.default_rng(SEED)

    # encode scan, random (start, freq) at the flagship grid, then the
    # extreme-freq case (freq 1 and 65535)
    p, k = 1956, LANES
    freq = rng.integers(1, 65536, (p, k)).astype(np.uint32)
    start = rng.integers(0, 65536 - freq).astype(np.uint32)
    cases = {
        "random": ((start << 16) | freq, rng.random((p, k)) < 0.85),
        "extreme_freq": (np.where(rng.random((p, k)) < 0.5, 1, 65535).astype(np.uint32),
                         np.ones((p, k), bool)),
    }
    enc_err = 0
    for name, (sf, kp) in cases.items():
        sf_t = torch.from_numpy(sf.view(np.int32)).to(dev)
        kp_t = torch.from_numpy(kp.astype(np.uint8)).to(dev)
        got = rans_cuda.rans_encode_scan(sf_t, kp_t)
        torch.cuda.synchronize()
        want = rans_cuda.rans_encode_scan_plain(sf_t, kp_t)
        err = max_abs_err(got, want)
        require(err == 0, f"encode kernel != plain twin ({name}): max|d| {err}")
        enc_err = max(enc_err, err)
        log(f"  encode scan {name} P={p} K={k}: kernel == plain twin")

    # real-table flagship stages: encode (kernel vs twin), then decode each
    # stage (kernel vs twin) and check the decoded values
    stages = flagship_stages(codec._tables, codec.gauss_row0, rng)
    dev_stages = [tuple(a.to(dev) for a in s) for s in stages]
    sf_rev, kp_rev, esc_flags, sym = rans_device.encode_prepare(dev_stages, t, LANES)
    require(sf_rev.shape == (1956, LANES), f"flagship grid is {tuple(sf_rev.shape)}")
    got = rans_cuda.rans_encode_scan(sf_rev, kp_rev)
    torch.cuda.synchronize()
    want = rans_cuda.rans_encode_scan_plain(sf_rev, kp_rev)
    err = max_abs_err(got, want)
    require(err == 0, f"encode kernel != plain twin (flagship tables): max|d| {err}")
    enc_err = max(enc_err, err)
    log(f"  encode scan flagship-table stages P=1956 K={LANES}: kernel == plain twin")
    enc_ms = cuda_time_ms(lambda: rans_cuda.rans_encode_scan(sf_rev, kp_rev), reps=20)
    enc_plain_ms = cuda_time_ms(lambda: rans_cuda.rans_encode_scan_plain(sf_rev, kp_rev),
                                reps=2, warmup=1)
    streams, n_words, escs, n_esc = rans_device.encode_finalize(*got, esc_flags, sym, LANES)
    streams = streams[:, : int(n_words)]
    escs = torch.nn.functional.pad(escs[:, : 2 * int(n_esc)], (0, 2))
    log(f"  flagship-table stream: {int(n_words)} words, {int(n_esc)} escapes")

    grids = []
    for s_sym, s_idx, s_keep in dev_stages:
        grids.append((rans_device._pad_to_grid(s_idx, LANES),
                      rans_device._pad_to_grid(s_keep.to(torch.uint8), LANES)))
    rows_of = stage_rows(codec, len(grids))
    dec_sf = rans_device.twin_dec_sf(codec._tables, dev)
    dec_err = 0
    dec0 = rans_device.decoder_init(streams, LANES)
    dec = dec0
    kept = 0
    for (s_sym, s_idx, s_keep), (ig, kg), rows in zip(dev_stages, grids, rows_of):
        got = rans_cuda.rans_decode_scan(dec.states, dec.offsets, streams, ig, kg, t.dec_sf,
                                         t.compact, rows)
        torch.cuda.synchronize()
        want = rans_cuda.rans_decode_scan_plain(dec.states, dec.offsets, streams, ig, kg, dec_sf)
        err = max_abs_err(got, want)
        require(err == 0, f"decode kernel != plain twin: max|d| {err}")
        dec_err = max(dec_err, err)
        esc_off, vals = rans_device.decode_stage_values(
            dec.esc_offsets, got[2], escs, s_idx, s_keep, t, LANES
        )
        require(torch.equal(vals, torch.where(s_keep, s_sym, 0)), "decoded values != symbols")
        dec = rans_device.DecoderState(got[0], got[1], esc_off)
        kept += int(s_keep.sum())
    require(bool(rans_device.stream_ok(dec)), "flagship-table stream: stream_ok is False")
    require(int(dec.offsets) == int(n_words), "decoder did not consume the whole payload")
    log(f"  decode scan, 12 flagship-table stages: kernel == plain twin, values exact, stream_ok")

    def dec_all(plain):
        d = dec0
        for (ig, kg), rows in zip(grids, rows_of):
            if plain:
                s, o, _ = rans_cuda.rans_decode_scan_plain(d.states, d.offsets, streams, ig, kg, dec_sf)
            else:
                s, o, _ = rans_cuda.rans_decode_scan(d.states, d.offsets, streams, ig, kg, t.dec_sf,
                                                     t.compact, rows)
            d = rans_device.DecoderState(s, o, d.esc_offsets)

    dec_ms = cuda_time_ms(lambda: dec_all(False), reps=10)
    dec_plain_ms = cuda_time_ms(lambda: dec_all(True), reps=1, warmup=1)
    floor = sorted(decode_wrapper_floor(dev))
    log(f"  decode wrapper floor, 12 launches of 0 rows: median {floor[len(floor) // 2]:.4f} ms, "
        f"min {floor[0]:.4f}, max {floor[-1]:.4f} over {len(floor)} passes "
        f"({100 * floor[len(floor) // 2] / dec_ms:.1f}% of the 12 scans' {dec_ms:.4f} ms)")
    for rows in sorted(set(rows_of)):
        plan = rans_cuda.plan_decode(t.compact, rows, LANES, rans_cuda._smem_optin(0))
        log(f"  decode plan, CDF rows {rows}: {plan.smem_bytes} bytes of dynamic shared memory "
            f"per CTA, table in shared memory {plan.table_in_smem}, bucket shift {plan.shift}, "
            f"stream ring {plan.ring_words} words")

    # a small stream coded on the CPU (plain twins) is the reference for the
    # same stream coded on the card (kernels)
    small = flagship_stages(codec._tables, codec.gauss_row0, np.random.default_rng(1))[:3]
    small = [tuple(a[:3000] for a in s) for s in small]
    cpu_t = rans_device.DeviceTables.from_tables(codec._tables, "cpu")
    ref = rans_device.encode_stages(small, cpu_t, 64)
    out = rans_device.encode_stages([tuple(a.to(dev) for a in s) for s in small], t, 64)
    require(int(ref[1]) == int(out[1])
            and torch.equal(ref[0][0, : int(ref[1])], out[0][0, : int(out[1])].cpu()),
            "small stream: card != CPU reference")
    log("  small stream (3 stages, 64 lanes): card kernels == CPU plain twins, byte for byte")

    cells = 1956 * LANES
    enc_bytes = cells * (4 + 1 + 2 + 1) + 4 * LANES
    enc_ops = cells * 30  # renorm test, shifts, masks and the magic-multiplier divmod
    results["rans_encode_scan"] = dict(
        ms=enc_ms, plain_ms=enc_plain_ms, max_abs_err=enc_err,
        bound_ms=1e3 * max(enc_bytes / MEM_BYTES_PER_S, enc_ops / INT32_OPS_PER_S),
        bound_by="bytes" if enc_bytes / MEM_BYTES_PER_S >= enc_ops / INT32_OPS_PER_S else "operations",
    )
    bound_ms, bound_by = decode_bound(t, rows_of, cells, int(n_words) - 2 * LANES, LANES)
    results["rans_decode_scan"] = dict(ms=dec_ms, plain_ms=dec_plain_ms, max_abs_err=dec_err,
                                       bound_ms=bound_ms, bound_by=bound_by)
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms ({1e6 * r['ms'] / 1956:.1f} ns per row), "
            f"plain twin {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return results


def decode_case(label, codec, stages, rows_of, lanes, dev, groups=1, smem_cap=None, timed=False):
    """Code `stages` as G = `groups` sub-streams of K=`lanes` lanes on the
    card (the encode kernel over whole warps against its twin, then each
    group's compaction), then decode every stage with the decode kernel and
    its twin, bit for bit, with the decoded values exact and stream_ok.
    Returns the rows, the payload words consumed, the kernel ms of all
    stages as a chain (CUDA events, host included), the twin's when
    `timed`, the largest |kernel - twin| and the stages' bound."""
    from progressivecodec_tpu_torch.coder import rans_cuda, rans_device

    t = codec.device_tables
    dec_sf = rans_device.twin_dec_sf(codec._tables, dev)
    dstages = [tuple(a.to(dev) for a in s) for s in stages]
    sf_rev, kp_rev, esc_flags, sym = rans_device.encode_prepare(dstages, t, lanes)
    enc = rans_device.encode_scan_rev(sf_rev, kp_rev, lanes)
    torch.cuda.synchronize()
    err = max_abs_err(enc, rans_cuda.rans_encode_scan_plain(sf_rev, kp_rev))
    require(err == 0, f"{label}: encode kernel != plain twin: max|d| {err}")
    streams, n_words, escs, n_escs = rans_device.encode_finalize(*enc, esc_flags, sym, lanes, groups)
    if groups == 1:
        streams = streams[:, : int(n_words)]
    escs = torch.nn.functional.pad(escs, (0, 2))
    grids = [(rans_device._pad_to_grid(s_idx, lanes),
              rans_device._pad_to_grid(s_keep.to(torch.uint8), lanes)) for _, s_idx, s_keep in dstages]
    dec0 = rans_device.decoder_init(streams, lanes)
    dec = dec0
    for (s_sym, s_idx, s_keep), (ig, kg), rows in zip(dstages, grids, rows_of):
        got = rans_cuda.rans_decode_scan(dec.states, dec.offsets, streams, ig, kg, t.dec_sf,
                                         t.compact, rows, smem_cap=smem_cap)
        torch.cuda.synchronize()
        want = rans_cuda.rans_decode_scan_plain(dec.states, dec.offsets, streams, ig, kg, dec_sf)
        err = max_abs_err(got, want)
        require(err == 0, f"{label}: decode kernel != plain twin: max|d| {err}")
        esc_off, vals = rans_device.decode_stage_values(dec.esc_offsets, got[2], escs, s_idx, s_keep, t, lanes)
        require(torch.equal(vals, torch.where(s_keep, s_sym, 0)), f"{label}: decoded values != symbols")
        dec = rans_device.DecoderState(got[0], got[1], esc_off)
    require(bool(rans_device.stream_ok(dec)) and torch.equal(dec.offsets, n_words.to(torch.int32)),
            f"{label}: stream_ok is False")

    def run(plain):
        d = dec0
        for (ig, kg), rows in zip(grids, rows_of):
            if plain:
                s, o, _ = rans_cuda.rans_decode_scan_plain(d.states, d.offsets, streams, ig, kg, dec_sf)
            else:
                s, o, _ = rans_cuda.rans_decode_scan(d.states, d.offsets, streams, ig, kg, t.dec_sf,
                                                     t.compact, rows, smem_cap=smem_cap)
            d = rans_device.DecoderState(s, o, d.esc_offsets)

    n_rows = sum(ig.shape[0] for ig, _ in grids)
    consumed = int(n_words.sum()) - 2 * lanes
    ms = cuda_time_ms(lambda: run(False), reps=10 if timed else 3, warmup=1)
    plain_ms = cuda_time_ms(lambda: run(True), reps=1, warmup=0) if timed else None
    plan = rans_cuda.plan_decode(t.compact, rows_of[-1], lanes // groups, smem_cap or rans_cuda._smem_optin(0))
    bound_ms, bound_by = decode_bound(t, rows_of, n_rows * lanes, consumed, lanes, groups)
    entry = rans_cuda.decode_entry(groups, lanes, plan.ctas)
    cluster = (f" in clusters of {rans_cuda.decode_cluster(groups)}"
               if entry == "grouped" and plan.table_in_smem else "")
    per_row = f"{1e6 * ms / n_rows:.1f} ns per row" if n_rows else "no rows"
    log(f"  decode case {label}: P={n_rows} K={lanes} G={groups} (kt={lanes // groups}), "
        f"{int(n_words.sum())} words, {int(n_escs.sum())} escapes: encode and decode kernels == plain "
        f"twins, values exact, stream_ok; {entry} entry, {plan.ctas} CTA(s) of {plan.cta_lanes} threads "
        f"per group{cluster}, ring {plan.ring_words} words, table in shared memory {plan.table_in_smem} "
        f"(shift {plan.shift}), {plan.smem_bytes} B shared memory per CTA; decode {ms:.4f} ms ({per_row})"
        + (f", twin {plain_ms:.2f} ms, bound {bound_ms:.5f} ms ({bound_by})" if timed else ""))
    return dict(rows=n_rows, consumed=consumed, ms=ms, plain_ms=plain_ms, max_abs_err=0, bound_ms=bound_ms,
                bound_by=bound_by)


def check_decode_cases(codec, dev):
    """Phase 3, second part: the decode kernel's edge cases."""
    from progressivecodec_tpu_torch.coder import rans_cuda

    tables = codec._tables
    t = codec.device_tables
    row0, r = codec.gauss_row0, tables.cdf.shape[0]
    rng = np.random.default_rng(SEED + 2)
    gauss = (row0, r)

    def one_row_stage(row, n, escape):
        lo = int(tables.offset[row])
        hi = lo + int(tables.max_symbol[row])
        sym = (np.full(n, hi + 1000) if escape else rng.integers(lo, hi + 1, n)).astype(np.int32)
        return tuple(torch.from_numpy(a) for a in
                     (sym, np.full(n, row, np.int32), np.ones(n, bool)))

    widest = row0 + int(np.argmax(tables.cdf_length[row0:]))
    narrowest = row0 + int(np.argmin(tables.cdf_length[row0:]))
    decode_case(f"widest Gaussian row {widest} alone", codec,
                [one_row_stage(widest, 200 * LANES, False)], [(widest, widest + 1)], LANES, dev)
    decode_case("every lane renormalising in every row (ring wraps)", codec,
                [one_row_stage(narrowest, 300 * LANES, True)], [gauss], LANES, dev)
    small = flagship_stages(tables, row0, np.random.default_rng(SEED + 3))
    small = [small[0], small[1], tuple(a[:50_000] for a in small[-1])]
    for lanes in (32, 64, 1024):
        decode_case(f"z, one base slice, part of the enhancement at K={lanes}", codec, small,
                    stage_rows(codec, 3), lanes, dev)
    decode_case("stages of P=1, P=0 and P=1 rows", codec,
                [one_row_stage(widest, 300, False), one_row_stage(widest, 0, False),
                 one_row_stage(narrowest, LANES, False)], [gauss] * 3, LANES, dev)
    pmf = flagship_stages(tables, row0, np.random.default_rng(SEED + 6), from_pmf=True)
    decode_case("flagship-table stages, symbols drawn from each row's distribution", codec, pmf,
                stage_rows(codec, len(pmf)), LANES, dev)
    b8 = flagship_stages(tables, row0, np.random.default_rng(SEED + 4), batch=8)
    rows8 = decode_case("batch-8 flagship grid", codec, b8, stage_rows(codec, len(b8)), LANES, dev)["rows"]
    require(rows8 == 15_648, f"batch-8 grid has {rows8} rows, want 15,648")
    flag3 = flagship_stages(tables, row0, np.random.default_rng(SEED + 5))[:3]
    cap = max(rans_cuda.decode_smem_bytes(LANES, 1, 0, 0, plan.ring_words, False)
              for plan in [rans_cuda.plan_decode(t.compact, gauss, LANES, 1 << 30)])
    for rows in stage_rows(codec, 3):
        require(not rans_cuda.plan_decode(t.compact, rows, LANES, cap).table_in_smem,
                "the global-table case did not select the global-table path")
    decode_case("global-table path (rings-only shared memory), z and two base slices", codec,
                flag3, stage_rows(codec, 3), LANES, dev, smem_cap=cap)


def check_grouped_cases(codec, dev):
    """Phase 3, third part: the PCT1-G decode against its twin.  Returns the
    kernel-table entry, measured on the flagship-table stages at K=512, G=4
    (kt=128), the grouped flagship round trip's shape."""
    tables = codec._tables
    row0 = codec.gauss_row0
    flag = flagship_stages(tables, row0, np.random.default_rng(SEED + 7))
    rows_of = stage_rows(codec, len(flag))
    case = decode_case("flagship-table stages", codec, flag, rows_of, LANES, dev, groups=4, timed=True)
    decode_case("flagship-table stages", codec, flag, rows_of, LANES, dev, groups=16, timed=True)
    decode_case("flagship-table stages", codec, flag, rows_of, LANES, dev, groups=2)
    log_split(scan_split(tables, codec.device_tables, row0, dev))
    small = flagship_stages(tables, row0, np.random.default_rng(SEED + 8))
    small = [small[0], small[1], tuple(a[:50_000] for a in small[-1])]
    for lanes, groups in ((32, 4), (1024, 2), (64, 64), (96, 3)):
        decode_case("z, one base slice, part of the enhancement", codec, small, stage_rows(codec, 3),
                    lanes, dev, groups=groups)
    return {key: case[key] for key in ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def synthetic_image(batch: int, seed: int, h: int = H, w: int = W):
    """Seeded natural-looking h x w (default 768x512) images in [0, 1],
    NHWC float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(batch):
        f = rng.uniform(0.005, 0.03, (3, 2))
        ph = rng.uniform(0, 2 * np.pi, (3, 2))
        img = np.stack([0.5 + 0.25 * np.sin(f[c, 0] * xx + ph[c, 0]) * np.cos(f[c, 1] * yy + ph[c, 1])
                        for c in range(3)], axis=-1)
        img += 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32)
        out.append(np.clip(img, 0.0, 1.0))
    return np.stack(out).astype(np.float32)


# the port's counter totals when `zero_launches` last ran
_launch_base: dict = {}


def zero_launches():
    from progressivecodec_tpu_torch.utils import profiling

    _launch_base.clear()
    _launch_base.update(profiling.totals())


def launches_since(name: str) -> int:
    """`launch:<name>` (a kernel wrapper or a spanning route) counted since
    `zero_launches`."""
    from progressivecodec_tpu_torch.utils import profiling

    return profiling.total(f"launch:{name}") - _launch_base.get(f"launch:{name}", 0)


def read_launches():
    """(encode, decode) launches since `zero_launches`."""
    return tuple(launches_since(n) for n in ("rans_encode_scan", "rans_decode_scan"))


def read_deconvs():
    """(kernel launches, cuDNN fallbacks) of g_s's transposed convolution
    since `zero_launches`."""
    from progressivecodec_tpu_torch.utils import profiling

    fallbacks = profiling.total("fallback:deconv2d") - _launch_base.get("fallback:deconv2d", 0)
    return launches_since("deconv2d"), fallbacks


def roundtrip(codec, x, q, label, *, latent=None, want_y_hat=None, cust_map=None):
    """One checked round trip (an importance map `cust_map` on both sides
    when given); the launch counts are zeroed just before it and read just
    after it.  Returns the counts, the escape words, y_hat and the bytes."""
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if latent is None:
        data = codec.compress(x, quality=q, simulate=True, cust_map=cust_map)
    else:
        data = codec.compress_from_latent(latent, x.shape, quality=q, simulate=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blob = codec.serialize(data)
    back = codec.deserialize(blob)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = codec.decompress(back, cust_map=cust_map)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    enc_n, dec_n = read_launches()
    deconv_n, fallback_n = read_deconvs()

    b = x.shape[0]
    cfg = codec.cfg
    require(out["stream_ok"], f"{label}: stream_ok is False")
    require(torch.equal(out["y_hat"], data["y_hat"]), f"{label}: decoded y_hat != encoder y_hat")
    if want_y_hat is not None:
        require(torch.equal(out["y_hat"], want_y_hat), f"{label}: y_hat != the one-stream codec's")
    require(tuple(out["x_hat"].shape) == (b, H, W, 3), f"{label}: x_hat shape {tuple(out['x_hat'].shape)}")
    require(bool(torch.isfinite(out["x_hat"]).all()), f"{label}: x_hat not finite")
    require(enc_n == 1, f"{label}: {enc_n} encode scan launches, want 1")
    # one decode launch per stage: z, the base slices, then the stacked
    # enhancement stage or one per unrolled enhancement slice
    if not codec._progressive:
        want_dec = 1 + cfg.M // cfg.dim_chunk
    elif q == 0:
        want_dec = 1 + cfg.ns0
    else:
        want_dec = 1 + cfg.ns0 + (1 if codec.model.stacked else cfg.num_prog_slices)
    require(dec_n == want_dec, f"{label}: {dec_n} decode launches, want {want_dec}")
    # g_s's four transposed convolutions on the kernel, in compress (simulate)
    # and in decompress, and none on cuDNN
    require((deconv_n, fallback_n) == (8, 0),
            f"{label}: {deconv_n} deconv launches and {fallback_n} cuDNN fallbacks, want 8 and 0")
    n_esc = sum(len(e) for e in back["escs"])
    bpp = 8 * len(blob) / (b * H * W)
    log(f"  {label}: {len(blob)} bytes ({bpp:.4f} bpp), {n_esc // 2} escapes, "
        f"encode {1e3 * (t1 - t0):.1f} ms, decode {1e3 * (t3 - t2):.1f} ms, launches encode={enc_n} "
        f"decode={dec_n} deconv={deconv_n}, stream_ok, y_hat bit-exact")
    return {"enc": enc_n, "dec": dec_n, "deconv": deconv_n, "esc": n_esc, "y_hat": out["y_hat"],
            "bytes": len(blob), "encode_ms": 1e3 * (t1 - t0), "decode_ms": 1e3 * (t3 - t2)}


def kept_and_blob(codec, x, q):
    """(keep flags of every unrolled enhancement slice, the container) of
    one compress."""
    kept = []
    orig = codec.model.codec_prog_params

    def spy(*args):
        out = orig(*args)
        kept.append(out[4])
        return out

    codec.model.codec_prog_params = spy
    try:
        data = codec.compress(x, quality=q)
    finally:
        del codec.model.codec_prog_params
    return torch.cat(kept, dim=-1), codec.serialize(data)


def check_rem(dev, x1, cfg, lanes=LANES):
    """Phase 5: REM with live banks through the codec, then the escalation
    cascade.  Returns the cascade's launch counts."""
    from progressivecodec_tpu_torch.models import rem
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec

    model = seeded_model(cfg, dev)
    g = torch.Generator().manual_seed(SEED + 5)
    zero_out = [m.zero_out.weight for levels in model.post_latent for m in levels]
    with torch.no_grad():
        for w in zero_out:
            w.copy_(0.02 * torch.randn(w.shape, generator=g, dtype=torch.float32))
    n_params = sum(p.numel() for p in model.parameters())
    bank_params = sum(p.numel() for p in model.post_latent.parameters())
    log(f"  REM: {n_params} parameters ({bank_params} in {len(zero_out)} banks), "
        f"unrolled {not model.stacked}")
    codec = GranularCodec(model, lanes=lanes, device=dev)
    roundtrip(codec, x1, 10, "REM warm-up q=10 b=1")
    for q in (0.01, 0.25, 1.0, 10):
        roundtrip(codec, x1, q, f"REM q={q} b=1")

    keep_live, blob_live = kept_and_blob(codec, x1, 1.0)
    saved = [w.clone() for w in zero_out]
    with torch.no_grad():
        for w in zero_out:
            w.zero_()
        keep_id, blob_id = kept_and_blob(codec, x1, 1.0)
        for w, v in zip(zero_out, saved):
            w.copy_(v)
    moved = int((keep_live != keep_id).sum())
    log(f"  REM bank live at q=1.0: keep count {int(keep_live.sum())} (identity model "
        f"{int(keep_id.sum())}: the quantile fixes it), {moved} keep flags differ, "
        f"{len(blob_live)} bytes (identity model {len(blob_id)}), streams differ "
        f"{blob_live != blob_id}")
    require(moved > 0 and blob_live != blob_id, "REM banks did not change the stream")

    grouped = GranularCodec(model, lanes=lanes, groups=4, device=dev)
    roundtrip(grouped, x1, 1.0, "REM groups=4 warm-up q=1.0 b=1")
    roundtrip(grouped, x1, 1.0, "REM groups=4 q=1.0 b=1")
    del grouped

    rem.escalation_compress(codec, x1, quality=10.0)  # warm-up
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = rem.escalation_compress(codec, x1, quality=10.0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blobs = [codec.serialize(d) for d in data["checkpoints"] + [data["final"]]]
    sent = [codec.deserialize(b) for b in blobs]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = rem.escalation_decompress(codec, {"checkpoints": sent[:-1], "final": sent[-1]})
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_launches()
    require(out["stream_ok"], "escalation: stream_ok is False")
    require(len(out["anchors"]) == len(data["anchors"]) == len(cfg.check_levels),
            "escalation: wrong number of checkpoint levels")
    require(all(torch.equal(a, b) for a, b in zip(out["anchors"], data["anchors"])),
            "escalation: the decoder's anchors != the encoder's")
    require(torch.equal(out["y_hat"], data["final"]["y_hat"])
            and torch.equal(out["x_hat"], data["final"]["x_hat"]),
            "escalation: decoded y_hat or x_hat != the encoder's")
    n_levels = len(blobs)
    want = (n_levels, n_levels * (1 + cfg.ns0 + cfg.num_prog_slices))
    require(launches == want, f"escalation: {launches} launches, want {want}")
    log(f"  REM escalation q=10: bytes per level {[len(b) for b in blobs]} (total "
        f"{sum(len(b) for b in blobs)}), encode {1e3 * (t1 - t0):.1f} ms, decode "
        f"{1e3 * (t3 - t2):.1f} ms, launches encode={launches[0]} decode={launches[1]}, "
        f"every stream_ok, anchors, y_hat and x_hat bit-exact")
    return launches


def check_eval(codec, n_images=2, qualities=(0.0, 5.0, 10.0)):
    """Phase 6: the real-codec and entropy-estimate ladders on the flagship
    over SyntheticKodak, then the eval CLI in this process."""
    from progressivecodec_tpu_torch.cli import eval as eval_cli
    from progressivecodec_tpu_torch.data.datasets import SyntheticKodak
    from progressivecodec_tpu_torch.training.evaluate import entropy_estimate_eval, evaluate_codec

    ds = SyntheticKodak(n=n_images)
    images = [ds[i] for i in range(len(ds))]
    zero_launches()
    real = evaluate_codec(codec, images, pr_list=qualities)
    launches = read_launches()
    n_dec = sum(1 + codec.cfg.ns0 + (q > 0) for q in qualities) * n_images
    want = (len(qualities) * n_images, n_dec)
    require(launches == want, f"evaluate_codec: {launches} launches, want {want}")
    est = entropy_estimate_eval(codec, images, pr_list=qualities)
    for j, q in enumerate(qualities):
        log(f"  eval q={q}: real {real['bpp'][j]:.4f} bpp, {real['psnr'][j]:.3f} dB PSNR, "
            f"{real['ms_ssim_db'][j]:.3f} dB MS-SSIM, encode {1e3 * real['enc_time'][j]:.1f} ms, "
            f"decode {1e3 * real['dec_time'][j]:.1f} ms; estimate {est['bpp'][j]:.4f} bpp, "
            f"{est['psnr'][j]:.3f} dB PSNR")
        require(np.isfinite([real["bpp"][j], real["psnr"][j], real["ms_ssim_db"][j],
                             est["bpp"][j], est["psnr"][j]]).all(), f"eval q={q}: not finite")
        require(real["bpp"][j] < est["bpp"][j] * 1.25 + 0.3,
                f"eval q={q}: real bpp {real['bpp'][j]} beyond the estimate's bound")
    log(f"  evaluate_codec launches over {n_images} images x {len(qualities)} qualities: "
        f"encode={launches[0]} decode={launches[1]}")
    t0 = time.perf_counter()
    result = eval_cli.main(["--synthetic", "--max-images", "1", "--qualities", "0,10"])
    require(result["real_codec"]["bpp"][0] < result["real_codec"]["bpp"][1]
            and all(r < e * 1.25 + 0.3 for r, e in zip(result["real_codec"]["bpp"],
                                                        result["entropy_estimate"]["bpp"])),
            "cli.eval: bpp out of order or beyond the estimate's bound")
    log(f"  cli.eval in process on {result['device']}: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------


def _records(out):
    with open(f"{out}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def check_training(dev, smi, keep=None):
    """Phase 7: `cli.train` on the flagship ModelConfig() at TrainConfig()
    defaults (batch 16, patch 256), 2 epochs of 4 steps, then a resume to
    epoch 3, then `cli.eval --checkpoint` on its last checkpoint, then one
    step on the card against the same step on the CPU.  The run directory
    (metrics.jsonl, ckpt_last, ckpt_best) is moved to `keep` when given.
    Returns the encode and decode launches counted during the trainer's
    real-codec evals."""
    import os
    import shutil
    import tempfile

    from progressivecodec_tpu_torch.cli import eval as eval_cli
    from progressivecodec_tpu_torch.cli import train as train_cli
    from progressivecodec_tpu_torch.config import ModelConfig, TrainConfig
    from progressivecodec_tpu_torch.training import checkpoint

    step_ms, eval_launches, saves = [], [], []
    make_step, evaluate, save = (train_cli.make_train_step, train_cli.evaluate_codec,
                                 train_cli.save_checkpoint)

    def timed_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            return out

        return timed

    def counted_eval(*a, **kw):
        zero_launches()
        out = evaluate(*a, **kw)
        eval_launches.append(read_launches())
        return out

    def timed_save(path, *a, **kw):
        t0 = time.perf_counter()
        save(path, *a, **kw)
        saves.append((time.perf_counter() - t0, _dir_bytes(path)))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out = os.path.join(tmp, "run")
    last = os.path.join(out, "ckpt_last")
    train_cli.make_train_step, train_cli.evaluate_codec, train_cli.save_checkpoint = (
        timed_make_step, counted_eval, timed_save)
    try:
        args = ["--synthetic", "--steps-per-epoch", "4", "--eval-every", "1", "--out", out]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.main(args + ["--epochs", "2"])
        t1 = time.perf_counter()
        payload, meta = checkpoint.read_checkpoint(last)
        require(payload["step"] == 8 and meta["extra"]["epoch"] == 1,
                f"ckpt_last after 2 epochs: step {payload['step']}, epoch {meta['extra']['epoch']}")
        del payload
        n_first = len(_records(out))
        train_cli.main(args + ["--epochs", "3", "--checkpoint", last])
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        recs = _records(out)
        resumed = recs[n_first:]
        require(min(r["epoch"] for r in resumed) == 2, "the resumed run did not start at epoch 2")
        steps = {r["epoch"]: r["step"] for r in recs if "step" in r}
        require(steps == {0: 4, 1: 8, 2: 12}, f"steps per epoch {steps}, want 4, 8, 12")
        errors = [r for r in recs if "eval_error" in r]
        require(not errors, f"eval errors: {errors}")
        for key in ("train_loss", "valid", "test", "real_codec"):
            got = sorted(r["epoch"] for r in recs if key in r)
            require(got == [0, 1, 2], f"{key} records at epochs {got}")
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        losses += [r["valid"]["loss"] for r in recs if "valid" in r]
        require(bool(np.isfinite(losses).all()), f"a logged loss is not finite: {losses}")
        cfg = ModelConfig()
        want = (6, 2 * sum(1 + cfg.ns0 + (q > 0) for q in (0.0, 1.0, 10.0)))
        require(len(eval_launches) == 3 and all(n == want for n in eval_launches),
                f"real-codec eval launches {eval_launches}, want {want} per epoch")
        real = [r["real_codec"] for r in recs if "real_codec" in r]
        for r in recs:
            if "train_loss" in r or "real_codec" in r:
                log(f"  {json.dumps(r)[:400]}")

        t3 = time.perf_counter()
        result = eval_cli.main(["--checkpoint", last, "--synthetic", "--max-images", "2",
                                "--qualities", "0,1,10"])
        t4 = time.perf_counter()
        require(result["real_codec"]["bpp"] == real[-1]["bpp"],
                f"cli.eval --checkpoint bpp {result['real_codec']['bpp']} != the trainer's "
                f"last {real[-1]['bpp']}")
    finally:
        train_cli.make_train_step, train_cli.evaluate_codec, train_cli.save_checkpoint = (
            make_step, evaluate, save)
        if keep is not None and os.path.isdir(out):
            shutil.move(out, keep)
        shutil.rmtree(tmp, ignore_errors=True)

    later = step_ms[1:8] + step_ms[9:]  # each run's first step warms up
    med = float(np.median(later))
    tcfg = TrainConfig()
    log(f"  train: {len(step_ms)} steps, ms per step {[round(t, 1) for t in step_ms]}; median "
        f"after each run's first {med:.1f} ms, {tcfg.batch_size / med * 1e3:.2f} images/s "
        f"(batch {tcfg.batch_size}, {tcfg.patch_size}x{tcfg.patch_size})")
    log(f"  train: run 1 (2 epochs) {t1 - t0:.1f} s, resume (1 epoch) {t2 - t1:.1f} s, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"  checkpoints: {len(saves)} saves, {saves[0][1]} bytes each, save s "
        f"{[round(t, 2) for t, _ in saves]}")
    log(f"  real-codec eval launches per epoch (encode, decode): {eval_launches}")
    log(f"  cli.eval --checkpoint: real bpp {result['real_codec']['bpp']} = the trainer's last, "
        f"{t4 - t3:.1f} s")
    split_step(dev)
    card_vs_cpu(dev)
    log(f"  phase 7 on {smi}")
    return tuple(sum(n) for n in zip(*eval_launches))


def split_step(dev, batch=16, patch=256):
    """One train step of the flagship at TrainConfig() sizes, split by CUDA
    events into forward + loss, backward, the main gradients' clip, the
    main Adam and the aux Adam (the parts of `Optimizers.step`, called one
    by one); then one more step with every convolution's forward and
    backward timed by CUDA events from module hooks, summed by kind
    (Conv2d, ConvTranspose2d).  Returns the split in ms."""
    import torch.nn as nn

    from progressivecodec_tpu_torch.config import ModelConfig, TrainConfig
    from progressivecodec_tpu_torch.ops.noise import NoiseSource
    from progressivecodec_tpu_torch.training.optim import clip_by_global_norm_
    from progressivecodec_tpu_torch.training.step import init_train_state, train_loss

    state = init_train_state(seeded_model(ModelConfig(), dev), TrainConfig())
    opt = state.opt
    x = torch.rand((batch, patch, patch, 3), generator=torch.Generator().manual_seed(SEED + 6),
                   dtype=torch.float32)
    x = x.to(dev)
    noise = NoiseSource.seeded(SEED + 6, dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]

    def step():
        opt.zero_grad()
        ev[0].record()
        total, _ = train_loss(state.model, x, (0, 10), noise=noise)
        ev[1].record()
        total.backward()
        ev[2].record()
        clip_by_global_norm_(opt.main_params, opt.clip_max_norm)
        ev[3].record()
        opt.main.step()
        ev[4].record()
        opt.aux.step()
        ev[5].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

    step()
    split = dict(zip(("forward", "backward", "clip", "main_adam", "aux_adam"), step()))
    log(f"  step split (CUDA events, batch {batch}, {patch}x{patch}, {len(opt.main_params)} main "
        f"tensors): " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f", total {sum(split.values()):.1f} ms")

    starts, spans, handles = {}, [], []

    def hook(kind, phase, at_start):
        def fn(m, *_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            if at_start:
                starts[(id(m), phase)] = e
            else:
                spans.append((kind, phase, starts.pop((id(m), phase)), e))
        return fn

    for m in state.model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kind = "ConvTranspose2d" if isinstance(m, nn.ConvTranspose2d) else "Conv2d"
            handles += [m.register_forward_pre_hook(hook(kind, "forward", True)),
                        m.register_forward_hook(hook(kind, "forward", False)),
                        m.register_full_backward_pre_hook(hook(kind, "backward", True)),
                        m.register_full_backward_hook(hook(kind, "backward", False))]
    try:
        step()
    finally:
        for h in handles:
            h.remove()
    sums: dict = {}
    for kind, phase, a, b in spans:
        sums[(kind, phase)] = sums.get((kind, phase), 0.0) + a.elapsed_time(b)
    log("  convolutions in one step (CUDA events from module hooks): " + ", ".join(
        f"{kind} {phase} {ms:.1f} ms" for (kind, phase), ms in sorted(sums.items())))
    return split


def card_vs_cpu(dev, batch=2, patch=128):
    """One `make_train_step` of the flagship on the card and on the CPU, same
    weights, batch and noise (drawn on the CPU): loss and aux loss within
    rtol 1e-4, every gradient within ||dg|| / ||g|| <= 1e-3."""
    from progressivecodec_tpu_torch.config import ModelConfig, TrainConfig
    from progressivecodec_tpu_torch.ops.noise import NoiseSource
    from progressivecodec_tpu_torch.training.step import init_train_state, make_train_step

    cfg = ModelConfig()
    x = torch.rand((batch, patch, patch, 3), generator=torch.Generator().manual_seed(SEED + 7),
                   dtype=torch.float32)
    runs = []
    for where in (dev, torch.device("cpu")):
        state = init_train_state(seeded_model(cfg, where), TrainConfig())
        t0 = time.perf_counter()
        _, metrics = make_train_step()(state, x.to(where), NoiseSource.seeded(SEED + 7, "cpu"))
        if where.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, secs))
        del state
    (m_gpu, g_gpu, s_gpu), (m_cpu, g_cpu, s_cpu) = runs
    for k in ("loss", "aux_loss", "loss_total"):
        require(abs(m_gpu[k] - m_cpu[k]) <= 1e-4 * abs(m_cpu[k]),
                f"card vs CPU {k}: {m_gpu[k]} vs {m_cpu[k]}")
    worst, worst_name = 0.0, ""
    for n, g in g_cpu.items():
        ref = float(g.norm())
        rel = float((g_gpu[n] - g).norm()) / ref if ref > 0 else float(g_gpu[n].norm())
        if rel > worst:
            worst, worst_name = rel, n
    require(worst <= 1e-3, f"card vs CPU gradient {worst_name}: ||dg|| / ||g|| = {worst}")
    log(f"  card vs CPU, one step (batch {batch}, {patch}x{patch}): loss {m_gpu['loss']:.6g} vs "
        f"{m_cpu['loss']:.6g}, aux {m_gpu['aux_loss']:.6g} vs {m_cpu['aux_loss']:.6g}; worst "
        f"gradient ||dg||/||g|| {worst:.3g} ({worst_name}) over {len(g_cpu)} tensors; card "
        f"{s_gpu:.2f} s, CPU {s_cpu:.2f} s")



# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------


def stacked_keep(model, fn):
    """(fn's result, the keep flags of every stacked enhancement stage fn
    runs: the encoder's, then the decoder's)."""
    kept = []
    orig = model.codec_prog_stacked

    def spy(*args):
        out = orig(*args)
        kept.append(out[3])
        return out

    model.codec_prog_stacked = spy
    try:
        result = fn()
    finally:
        del model.codec_prog_stacked
    return result, kept


def device_busy_ms(trace: dict):
    """(ms during which the card ran a kernel, copy or fill, the number of
    such events) in a Chrome trace from torch.profiler: the union of their
    intervals."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans)


def snap_differences(model_a, xa, model_b, xb, table, q_eps=1e-6) -> int:
    """Elements whose snapped sigma differs between two models' forwards
    (base and minimal enhancement), as importance_map snaps them."""
    from progressivecodec_tpu_torch.layers.importance import snap_to_scale_table

    n = 0
    with torch.no_grad():
        for q in (0.0, q_eps):
            a = model_a.forward_single_quality(xa, q, "point-based-std")["std"]
            b = model_b.forward_single_quality(xb, q, "point-based-std")["std"]
            n += int((snap_to_scale_table(a, table).cpu() != snap_to_scale_table(b, table).cpu()).sum())
    return n


def check_importance(dev, x1, smi):
    """Phase 8: the importance map, the MaskEstractor and its trainer, a
    round trip ranked by the predicted map, ImportanceMapDataset,
    `cli.rd_sweep`, and the profiling tools: a recorded span around each,
    a torch.profiler trace of one round trip, the forward's FLOPs and MFU.
    Returns the launches of the map-ranked round trip and of rd_sweep."""
    import os
    import tempfile

    from progressivecodec_tpu_torch.cli import rd_sweep
    from progressivecodec_tpu_torch.config import ModelConfig
    from progressivecodec_tpu_torch.data.datasets import ImportanceMapDataset, SyntheticKodak
    from progressivecodec_tpu_torch.layers.importance import importance_map
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.models.registry import get_model
    from progressivecodec_tpu_torch.ops.noise import NoiseSource
    from progressivecodec_tpu_torch.training.mask_trainer import (
        importance_target, init_mask_estractor, make_mask_train_step, mask_features,
        predict_cust_map,
    )
    from progressivecodec_tpu_torch.utils.flops import chip_peak_flops, flops_by_kind, mfu
    from progressivecodec_tpu_torch.utils import profiling
    from progressivecodec_tpu_torch.utils.profiling import TRACE_FILE, device_trace

    cfg = ModelConfig()
    table = cfg.scale_table.values()
    t_ns = time.time_ns()

    @contextlib.contextmanager
    def phase(name):
        with profiling.recording(), profiling.span(f"smoke:{name}"):
            yield
            torch.cuda.synchronize()
    model = seeded_model(cfg, dev)
    b, h, w = 1, H // 16, W // 16

    with phase("importance_map 768x512"):
        imap = importance_map(model, x1, NoiseSource.seeded(SEED + 8), table)
    require(tuple(imap.shape) == (b, h, w, cfg.division_channel), f"importance map {tuple(imap.shape)}")
    require(bool(torch.isfinite(imap).all()) and bool((imap >= 0).all()) and float(imap.max()) > 0,
            "importance map: not finite, negative or all zero")
    imap_ms = cuda_time_ms(lambda: importance_map(model, x1, NoiseSource.seeded(SEED + 8), table), 3)
    require(all(p.grad is None for p in model.parameters()),
            "importance_map gave a model parameter a gradient")

    with phase("importance_map card vs CPU 256x256"):
        cpu_model = get_model(cfg, device="cpu")
        cpu_model.load_state_dict(model.state_dict(), strict=True)
        x256 = x1[:, :256, :256].contiguous()
        m_card = importance_map(model, x256, NoiseSource.seeded(SEED + 9), table).cpu()
        m_cpu = importance_map(cpu_model, x256.cpu(), NoiseSource.seeded(SEED + 9), table)
        rel = float(torch.linalg.vector_norm(m_card - m_cpu) / torch.linalg.vector_norm(m_cpu))
        n_snap = snap_differences(model, x256, cpu_model, x256.cpu(), table)
        del cpu_model
    log(f"  importance map (1, {h}, {w}, {cfg.division_channel}): {imap_ms:.2f} ms (CUDA events), "
        f"max {float(imap.max()):.4g}; card vs CPU at 256x256: ||d||/||m|| = {rel:.3g}, snapped "
        f"sigma differ at {n_snap} of {2 * 16 * 16 * cfg.division_channel} elements")
    require(rel <= 1e-3, f"importance map card vs CPU {rel} > 1e-3")

    with phase("MaskEstractor 10 steps"):
        feats = mask_features(model, x1)
        target = importance_target(model, x1, NoiseSource.seeded(SEED + 10), table)
        est = init_mask_estractor(torch.Generator().manual_seed(SEED + 11), model)
        _, step = make_mask_train_step(est, lr=1e-4)
        step(feats, target)  # warm-up, not counted
        est = init_mask_estractor(torch.Generator().manual_seed(SEED + 11), model)
        _, step = make_mask_train_step(est, lr=1e-4)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses = [step(feats, target) for _ in range(10)]
        end.record()
        torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    n_est = sum(p.numel() for p in est.parameters())
    log(f"  MaskEstractor(N={cfg.division_channel}, {n_est} parameters), 10 steps at lr 1e-4: "
        f"{start.elapsed_time(end) / 10:.2f} ms per step, loss {losses[0]:.6g} -> {losses[-1]:.6g}")
    require(np.isfinite(losses).all() and losses[-1] < losses[0], f"mask losses {losses}")

    with phase("cust_map round trip q=5"):
        cust_map = predict_cust_map(est, model, x1)
        codec = GranularCodec(model, lanes=LANES, device=dev)
        roundtrip(codec, x1, 5, "cust_map warm-up q=5 b=1", cust_map=cust_map)
        got, (keep_map, keep_dec) = stacked_keep(model, lambda: roundtrip(
            codec, x1, 5, "predicted cust_map q=5 b=1", cust_map=cust_map))
        _, (keep_sigma,) = stacked_keep(model, lambda: codec.compress(x1, quality=5))
    require(torch.equal(keep_map, keep_dec), "cust_map: the decoder's keep flags != the encoder's")
    moved = int((keep_map != keep_sigma).sum())
    log(f"  cust_map q=5: keep count {int(keep_map.sum())} (sigma ranking {int(keep_sigma.sum())}), "
        f"{moved} keep flags differ from the sigma-ranked codec's")
    require(moved > 0, "the predicted cust_map kept the same elements as sigma ranking")
    map_launches = (got["enc"], got["dec"])

    with phase("ImportanceMapDataset 2 items"):
        pairs = ImportanceMapDataset(SyntheticKodak(n=2), model, table, patch_size=256)
        for i in range(len(pairs)):
            patch, m = pairs[i]
            require(patch.shape == (256, 256, 3) and m.shape == (16, 16, cfg.division_channel)
                    and np.isfinite(m).all(), f"ImportanceMapDataset item {i}: {m.shape}")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rd.json")
        zero_launches()
        t0 = time.perf_counter()
        with phase("cli.rd_sweep coarse, 1 image"):
            res = rd_sweep.main(["--synthetic-kodak", "--image", "0", "--grid", "coarse",
                                 "--device", "cuda", "--out", out])
        rd_s = time.perf_counter() - t0
        rd_launches = read_launches()
        with open(out) as f:
            require(json.load(f) == res, "rd_sweep's JSON file != its result")
    n_q = len(res["qualities"])
    want = (n_q, sum(1 + cfg.ns0 + (q > 0) for q in res["qualities"]))
    log(f"  cli.rd_sweep: {n_q} qualities in {rd_s:.1f} s, bpp {[round(v, 4) for v in res['bpp']]}, "
        f"BD-rate {res['bd_rate_vs_fixed_pret']}, launches encode={rd_launches[0]} "
        f"decode={rd_launches[1]}")
    require(n_q == 12 and rd_launches == want, f"rd_sweep launches {rd_launches}, want {want}")
    require(all(a <= c for a, c in zip(res["bpp"], res["bpp"][1:])), "rd_sweep: bpp decreases with q")

    with tempfile.TemporaryDirectory() as tmp:
        with phase("device_trace q=10 round trip"):
            with device_trace(tmp) as prof:
                t0 = time.perf_counter()
                codec.decompress(codec.deserialize(codec.serialize(codec.compress(x1, quality=10))))
                torch.cuda.synchronize()
                traced_ms = 1e3 * (time.perf_counter() - t0)
        with open(os.path.join(tmp, TRACE_FILE)) as f:
            trace = f.read()
    kernel_names = ("rans_encode_scan_kernel", "rans_decode_scan_kernel")
    require(all(k in trace for k in kernel_names), "the profiler trace lacks a rANS kernel")
    busy_ms, n_kernels = device_busy_ms(json.loads(trace))
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    log(f"  device_trace: {len(trace)} bytes of Chrome trace naming {', '.join(kernel_names)}; "
        f"{n_kernels} device events busy {busy_ms:.2f} ms of a {traced_ms:.1f} ms round trip under "
        f"the profiler (idle share {1 - busy_ms / traced_ms:.3f}); most device time: "
        + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms" for e in top))

    fwd = lambda: model.forward_single_quality(x1, 10.0, "point-based-std")  # noqa: E731
    with torch.no_grad():
        kinds = flops_by_kind(fwd)
        fwd_ms = cuda_time_ms(fwd, 5)
    total = sum(kinds.values())
    peak, note = chip_peak_flops(dev)
    util = mfu(total, fwd_ms / 1e3, dev)
    log(f"  forward_single_quality 768x512 q=10: {total / 1e9:.2f} GFLOP (conv "
        f"{kinds['conv'] / 1e9:.2f}, conv_transpose {kinds['conv_transpose'] / 1e9:.2f}, matmul "
        f"{kinds['matmul'] / 1e9:.2f}), {fwd_ms:.2f} ms (CUDA events), MFU {util:.4f} of {note} "
        f"on {smi}")
    require(0 < util < 1, f"MFU {util} outside (0, 1)")
    for sp in profiling.spans():
        if sp.name.startswith("smoke:") and sp.t0_ns >= t_ns:
            log(f"  span {sp.name[len('smoke:'):]}: {(sp.t1_ns - sp.t0_ns) * 1e-9:.2f} s")
    return map_launches, rd_launches


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

P9_COLLECTIVE_S = 300  # each collective of a phase-9 rank waits at most this
P9_JOB_S = 600  # the 2-rank job as a whole


def p9_plan(dev, cfg=None, size=(1024, 2048), batch=16, patch=256):
    """What phase 9 runs: the device, the model, the tiled image's (H, W),
    the training batch and patch.  The defaults are the card's: the
    flagship, tools/bench_2k.py's 2048x1024, TrainConfig()'s batch 16 at
    256x256."""
    from progressivecodec_tpu_torch.config import ModelConfig

    return dict(dev=dev.type, cfg=cfg or ModelConfig(), size=size, batch=batch, patch=patch)


def p9_coder_stages(codec):
    """{lanes: stages}: phase 3's 12 flagship-table stages at K=LANES, and z,
    one base slice and part of the enhancement at K=32."""
    tables, row0 = codec._tables, codec.gauss_row0
    small = flagship_stages(tables, row0, np.random.default_rng(SEED + 10))
    return {LANES: flagship_stages(tables, row0, np.random.default_rng(SEED + 9)),
            32: [small[0], small[1], tuple(a[:50_000] for a in small[-1])]}


def p9_batch(plan):
    return torch.rand((plan["batch"], plan["patch"], plan["patch"], 3), dtype=torch.float32,
                      generator=torch.Generator().manual_seed(SEED + 11))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _p9_events(dev):
    """The two kernel wrappers and the sharded coder's gather, wrapped to
    time each call: CUDA events around each kernel launch, the host clock
    (after a sync) around each gather through host memory.  Returns
    (spans {name: [(start, end)] or [ms]}, restore)."""
    from progressivecodec_tpu_torch.coder import rans_cuda
    from progressivecodec_tpu_torch.parallel import sharded_coder

    spans = {"encode": [], "decode": [], "gather_ms": []}
    orig = (rans_cuda.rans_encode_scan, rans_cuda.rans_decode_scan, sharded_coder.all_gather)

    def evented(fn, key):
        def run(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            spans[key].append((e0, e1))
            return out
        return run

    def gather(*a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = orig[2](*a, **kw)
        _sync(dev)
        spans["gather_ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    rans_cuda.rans_encode_scan = evented(orig[0], "encode")
    rans_cuda.rans_decode_scan = evented(orig[1], "decode")
    sharded_coder.all_gather = gather

    def restore():
        rans_cuda.rans_encode_scan, rans_cuda.rans_decode_scan, sharded_coder.all_gather = orig

    return spans, restore


def _p9_coder(codec, mesh, dev, ref) -> dict:
    """9.1: this rank's group of the PCT1-G streams at (K, G) = (LANES, 2)
    and (32, 2), against the single-process encoder's streams at G = 2
    (`ref`), then the stage-wise sharded decode.  Returns, per K, the CUDA-
    event ms of this rank's encode launch and of its decode launches, and
    the host ms of its gathers."""
    from progressivecodec_tpu_torch.coder import rans_device
    from progressivecodec_tpu_torch.parallel.sharded_coder import (
        sharded_decode_stage,
        sharded_encode_stages,
    )

    t = codec.device_tables
    out = {}
    # each case twice: the first pass loads the kernels in this process and
    # warms the allocator; the second pass's times are kept
    for lanes, stages in [c for c in p9_coder_stages(codec).items() for _ in range(2)]:
        dstages = [tuple(a.to(dev) for a in s) for s in stages]
        spans, restore = _p9_events(dev)
        try:
            streams, n_words, escs, n_escs = sharded_encode_stages(dstages, t, lanes, mesh)
            for got, want, what in zip((streams, n_words, escs, n_escs), ref[lanes],
                                       ("streams", "n_words", "escs", "n_escs")):
                require(torch.equal(got.cpu(), want), f"sharded {what} != the encoder's at K={lanes}, G=2")
            padded = torch.nn.functional.pad(escs, (0, 2))
            dec = rans_device.decoder_init(streams, lanes)
            for (sym, idx, keep), rows in zip(dstages, stage_rows(codec, len(dstages))):
                dec, vals = sharded_decode_stage(dec, streams, padded, idx, keep, t, lanes, mesh,
                                                 rows=rows)
                require(torch.equal(vals, torch.where(keep, sym, 0)),
                        f"sharded decode values != symbols at K={lanes}")
            require(bool(rans_device.stream_ok(dec)) and torch.equal(dec.offsets, n_words.to(torch.int32)),
                    f"sharded decode at K={lanes}: stream_ok is False")
            _sync(dev)
        finally:
            restore()
        out[lanes] = dict(
            rows=sum(rans_device._pad_to_grid(s[1], lanes).shape[0] for s in dstages),
            encode_ms=sum(a.elapsed_time(b) for a, b in spans["encode"]),
            decode_ms=sum(a.elapsed_time(b) for a, b in spans["decode"]),
            decode_launches=len(spans["decode"]), gathers=len(spans["gather_ms"]),
            gather_ms=sum(spans["gather_ms"]),
        )
    return out


def _p9_tiled(model, mesh, dev, ref) -> dict:
    """9.2: the tiled analysis against the full width, then tiled round
    trips at q in {0, 10} with one stream and with the coder sharded over
    the ranks (groups=2), each against the untiled stream (`ref`), and each
    untiled stream decoded tiled."""
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.parallel import tiling

    x = ref["x"].to(dev)
    with torch.no_grad():
        y = tiling.tiled_analyze(model, x, mesh).cpu()
    rel = float((y - ref["y"]).abs().max() / ref["y"].abs().max())
    require(rel <= 1e-5, f"tiled analyze: max|dy| / max|y| = {rel}")
    out = {"analyze_rel": rel, "runs": {}}
    codecs = {1: GranularCodec(model, lanes=LANES, device=dev),
              2: GranularCodec(model, lanes=LANES, coder_mesh=mesh, device=dev)}
    tiling.tiled_decompress(codecs[1], tiling.tiled_compress(codecs[1], x, mesh), mesh)  # warm-up
    for groups, codec in codecs.items():
        for q in (0, 10):
            label = f"tiled groups={groups} q={q}"
            _sync(dev)
            t0 = time.perf_counter()
            data = tiling.tiled_compress(codec, x, mesh, quality=q, simulate=True)
            _sync(dev)
            t1 = time.perf_counter()
            blob = codec.serialize(data)
            back = codec.deserialize(blob)
            _sync(dev)
            t2 = time.perf_counter()
            dec = tiling.tiled_decompress(codec, back, mesh)
            _sync(dev)
            t3 = time.perf_counter()
            require(dec["stream_ok"], f"{label}: stream_ok is False")
            require(torch.equal(dec["y_hat"], data["y_hat"]), f"{label}: decoded y_hat != encoder y_hat")
            require(tuple(dec["x_hat"].shape) == tuple(x.shape) and bool(torch.isfinite(dec["x_hat"]).all()),
                    f"{label}: x_hat {tuple(dec['x_hat'].shape)} or not finite")
            untiled = ref["blobs"][groups, q]
            n = min(len(blob), len(untiled))
            diff_bytes = int((np.frombuffer(blob[:n], np.uint8) != np.frombuffer(untiled[:n], np.uint8)).sum()
                             + abs(len(blob) - len(untiled)))
            diff_symbols = int((data["y_hat"].cpu() != ref["y_hat"][groups, q]).sum())
            cross = tiling.tiled_decompress(codec, codec.deserialize(untiled), mesh)
            require(cross["stream_ok"] and torch.equal(cross["y_hat"].cpu(), ref["y_hat"][groups, q]),
                    f"{label}: the untiled stream does not decode tiled to its y_hat")
            out["runs"][groups, q] = dict(
                bytes=len(blob), untiled_bytes=len(untiled), diff_bytes=diff_bytes,
                diff_symbols=diff_symbols, encode_ms=1e3 * (t1 - t0), decode_ms=1e3 * (t3 - t2),
                blob=blob, y_hat=data["y_hat"].cpu(),
            )
    return out


def _p9_train(plan, dev, ref) -> dict:
    """9.3: one sharded step on (2, 1) and on (1, 2) against the
    single-process step (`ref`), then 3 more steps on (2, 1)."""
    from progressivecodec_tpu_torch.config import TrainConfig
    from progressivecodec_tpu_torch.ops.noise import NoiseSource
    from progressivecodec_tpu_torch.parallel.mesh import make_mesh
    from progressivecodec_tpu_torch.parallel.sharding import (
        gather_full, make_sharded_train_step, resident_param_bytes, shard_train_state,
    )
    from progressivecodec_tpu_torch.training.step import init_train_state

    x = p9_batch(plan).to(dev)
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(*shape, device_type=dev.type)
        state = shard_train_state(init_train_state(seeded_model(plan["cfg"], dev), TrainConfig()), mesh)
        step = make_sharded_train_step(mesh)
        noise = NoiseSource.seeded(SEED + 11, "cpu")
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, x, noise)
        _sync(dev)
        first_ms = 1e3 * (time.perf_counter() - t0)
        for k in ("loss", "aux_loss", "loss_total"):
            got, want = float(metrics[k]), ref["metrics"][k]
            require(abs(got - want) <= 1e-4 * abs(want), f"mesh {shape} {k}: {got} vs {want}")
        grads = gather_full(state, grads=True)
        require(set(grads) == set(ref["grads"]), f"mesh {shape}: other leaves have gradients")
        worst, worst_name = 0.0, ""
        for name, g in ref["grads"].items():
            g = g.to(dev)
            rel = float((grads[name] - g).norm() / g.norm()) if float(g.norm()) > 0 else float(grads[name].norm())
            if rel > worst:
                worst, worst_name = rel, name
        require(worst <= 1e-3, f"mesh {shape} gradient {worst_name}: ||dg|| / ||g|| = {worst}")
        names = {s.name for s in state.shards}
        full = {n: p.numel() * p.element_size() for n, p in ref["grads"].items()}
        sharded = sum(s.storage.numel() * s.storage.element_size() for s in state.shards)
        replicated = sum(p.numel() * p.element_size() for n, p in state.model.named_parameters()
                         if n not in names)
        more = []
        if shape == (2, 1):
            for _ in range(3):
                _sync(dev)
                t0 = time.perf_counter()
                state, m = step(state, x, noise)
                _sync(dev)
                more.append((1e3 * (time.perf_counter() - t0), float(m["loss"])))
            require(all(np.isfinite(loss) for _, loss in more), f"mesh {shape}: a loss is not finite {more}")
        out[shape] = dict(
            loss=float(metrics["loss"]), worst=worst, worst_name=worst_name, first_ms=first_ms,
            more=more, resident=resident_param_bytes(state), sharded_bytes=sharded,
            full_sharded_bytes=sum(full.get(n, 0) for n in names), replicated_bytes=replicated,
            n_shards=len(state.shards), n_params=len(ref["grads"]),
        )
        del state, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def p9_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of phase 9's 2-rank job (a spawned process): 9.1, 9.2 and
    9.3 on `workdir`'s plan and references; writes rank<rank>.pt with the
    results and this rank's kernel launches.  The kernels are loaded from
    phase 2's build, never built here."""
    import datetime
    import logging
    import os

    from progressivecodec_tpu_torch.device import set_deterministic
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.parallel import distributed
    from progressivecodec_tpu_torch.parallel.mesh import make_mesh

    logging.basicConfig(level=logging.INFO, format=f"  [rank {rank}] %(message)s", stream=sys.stdout)
    plan = torch.load(os.path.join(workdir, "plan.pt"), weights_only=False)
    dev = torch.device(plan["dev"])
    distributed.init_process_group(f"file://{workdir}/store", world, rank, "gloo",
                                   timeout=datetime.timedelta(seconds=P9_COLLECTIVE_S))
    try:
        set_deterministic()
        zero_launches()
        mesh = make_mesh(1, 2, device_type=dev.type)
        model = seeded_model(plan["cfg"], dev)
        codec = GranularCodec(model, lanes=LANES, device=dev)
        codec.update()
        ref = torch.load(os.path.join(workdir, "ref.pt"), weights_only=False)
        out = {"coder": _p9_coder(codec, mesh, dev, ref["coder"])}
        out["coder_launches"] = read_launches()
        out["tiled"] = _p9_tiled(model, mesh, dev, ref["tiled"])
        out["tiled_launches"] = read_launches()
        del model, codec
        out["train"] = _p9_train(plan, dev, torch.load(os.path.join(workdir, "train_ref.pt"),
                                                       weights_only=False))
        out["launches"] = read_launches()
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def p9_nccl(workdir: str, port: int) -> None:
    """9.4, a spawned process: a one-rank NCCL group from the environment,
    `allreduce_metrics`, an all_reduce, and one `sharded_encode_stages` /
    `sharded_decode_stage` at G=1 on CUDA tensors; writes nccl.pt."""
    import datetime
    import os

    from progressivecodec_tpu_torch.coder import rans_device
    from progressivecodec_tpu_torch.device import set_deterministic
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.parallel import distributed
    from progressivecodec_tpu_torch.parallel.mesh import make_mesh
    from progressivecodec_tpu_torch.parallel.sharded_coder import (
        sharded_decode_stage,
        sharded_encode_stages,
    )

    plan = torch.load(os.path.join(workdir, "plan.pt"), weights_only=False)
    os.environ.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", PROCESS_COUNT="1", PROCESS_ID="0")
    require(distributed.initialize_from_env("nccl", timeout=datetime.timedelta(seconds=120)) == (0, 1),
            "initialize_from_env did not give rank 0 of 1")
    try:
        set_deterministic()
        zero_launches()
        dev = torch.device("cuda")
        require(torch.distributed.get_backend() == "nccl", "the group's backend is not nccl")
        metrics = distributed.allreduce_metrics({"loss": 2.5})
        total = distributed.all_reduce(torch.full((4,), 3.0, device=dev))
        require(metrics == {"loss": 2.5} and bool((total == 3.0).all()), "one-rank NCCL reductions")
        mesh = make_mesh(1, 1)
        codec = GranularCodec(seeded_model(plan["cfg"], dev), lanes=LANES)
        codec.update()
        t = codec.device_tables
        stages = [tuple(a.to(dev) for a in s) for s in p9_coder_stages(codec)[32]]
        lanes = 64
        got = sharded_encode_stages(stages, t, lanes, mesh)
        want = rans_device.encode_stages(stages, t, lanes, 1)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                "NCCL G=1 sharded streams != the encoder's")
        streams, n_words, escs, _ = got
        padded = torch.nn.functional.pad(escs, (0, 2))
        dec = rans_device.decoder_init(streams, lanes)
        for (sym, idx, keep), rows in zip(stages, stage_rows(codec, len(stages))):
            dec, vals = sharded_decode_stage(dec, streams, padded, idx, keep, t, lanes, mesh, rows=rows)
            require(torch.equal(vals, torch.where(keep, sym, 0)), "NCCL G=1 decoded values != symbols")
        require(bool(rans_device.stream_ok(dec)), "NCCL G=1: stream_ok is False")
        torch.save({"launches": read_launches(), "words": int(n_words.sum())},
                   os.path.join(workdir, "nccl.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_spawned(jobs, timeout: float) -> None:
    """Run each (function, args) of `jobs` in a process started with spawn
    (this process has initialised CUDA); wait for all of them.  If one
    exits nonzero or the time runs out, every one is killed and this
    raises."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=args) for fn, args in jobs]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            codes = [p.exitcode for p in procs]
            require(all(c in (None, 0) for c in codes), f"a phase-9 process failed: exit codes {codes}")
            require(time.monotonic() < deadline, f"phase 9's processes ran past {timeout} s")
            time.sleep(0.5)
        codes = [p.exitcode for p in procs]
        require(all(c == 0 for c in codes), f"phase 9's processes exited {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def check_parallel(dev, smi, plan=None):
    """Phase 9: `parallel/` with two ranks sharing the card (gloo), then a
    one-rank NCCL group.  This process computes the references first (the
    single-process streams at G = 2, the untiled round trips and analysis at
    2048x1024, one single-process train step), then spawns the 2-rank job
    (`p9_rank`), decodes the ranks' tiled streams untiled, and runs
    `p9_nccl`.  Returns the kernels' launches in the ranks, (encode,
    decode)."""
    import os
    import shutil
    import socket
    import tempfile

    from progressivecodec_tpu_torch.coder import rans_device
    from progressivecodec_tpu_torch.config import TrainConfig
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.ops.noise import NoiseSource
    from progressivecodec_tpu_torch.training.step import init_train_state, make_train_step

    plan = plan or p9_plan(dev)
    h, w = plan["size"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        torch.save(plan, os.path.join(workdir, "plan.pt"))
        model = seeded_model(plan["cfg"], dev)
        codecs = {1: GranularCodec(model, lanes=LANES, device=dev),
                  2: GranularCodec(model, lanes=LANES, groups=2, device=dev)}
        codecs[1].update()
        coder_ref = {}
        for lanes, stages in p9_coder_stages(codecs[1]).items():
            dstages = [tuple(a.to(dev) for a in s) for s in stages]
            coder_ref[lanes] = tuple(a.cpu() for a in rans_device.encode_stages(
                dstages, codecs[1].device_tables, lanes, 2))
        x = torch.from_numpy(synthetic_image(1, SEED + 12, h, w)).to(dev)
        with torch.no_grad():
            y = model.analyze(x).cpu()
        tiled_ref = {"x": x.cpu(), "y": y, "blobs": {}, "y_hat": {}}
        untiled_ms = {}
        codecs[1].decompress(codecs[1].compress(x, quality=10))  # warm-up at this size
        for groups, codec in codecs.items():
            for q in (0, 10):
                _sync(dev)
                t0 = time.perf_counter()
                data = codec.compress(x, quality=q, simulate=True)
                _sync(dev)
                t1 = time.perf_counter()
                blob = codec.serialize(data)
                out = codec.decompress(codec.deserialize(blob))
                _sync(dev)
                t2 = time.perf_counter()
                require(out["stream_ok"] and torch.equal(out["y_hat"], data["y_hat"]),
                        f"untiled groups={groups} q={q} at {w}x{h}: round trip not exact")
                tiled_ref["blobs"][groups, q] = blob
                tiled_ref["y_hat"][groups, q] = data["y_hat"].cpu()
                untiled_ms[groups, q] = (1e3 * (t1 - t0), 1e3 * (t2 - t1))
        torch.save({"coder": coder_ref, "tiled": tiled_ref}, os.path.join(workdir, "ref.pt"))
        del model, codecs, tiled_ref

        state = init_train_state(seeded_model(plan["cfg"], dev), TrainConfig())
        _, metrics = make_train_step()(state, p9_batch(plan).to(dev), NoiseSource.seeded(SEED + 11, "cpu"))
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()
                              if p.grad is not None}},
                   os.path.join(workdir, "train_ref.pt"))
        ref_loss = float(metrics["loss"])
        del state, metrics
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        run_spawned([(p9_rank, (r, 2, workdir)) for r in range(2)], P9_JOB_S)
        job_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(2)]

        model = seeded_model(plan["cfg"], dev)
        codecs = {1: GranularCodec(model, lanes=LANES, device=dev),
                  2: GranularCodec(model, lanes=LANES, groups=2, device=dev)}
        for (groups, q), run in ranks[0]["tiled"]["runs"].items():
            out = codecs[groups].decompress(codecs[groups].deserialize(run["blob"]))
            require(out["stream_ok"] and torch.equal(out["y_hat"].cpu(), run["y_hat"]),
                    f"the tiled stream groups={groups} q={q} does not decode untiled to its y_hat")
        del model, codecs

        nccl = None
        if dev.type == "cuda":
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            run_spawned([(p9_nccl, (workdir, port))], 300)
            nccl = torch.load(os.path.join(workdir, "nccl.pt"), weights_only=False)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    share = "[two ranks time-share the card: not a scaling number]"
    log(f"  the 2-rank job took {job_s:.1f} s on {smi}; every time below is of two ranks "
        f"time-sharing one card, so none is a scaling number")
    for r, res in enumerate(ranks):
        for lanes, c in res["coder"].items():
            log(f"  9.1 rank {r} sharded coder K={lanes} G=2 (kt={lanes // 2}), {c['rows']} rows: "
                f"streams == the encoder's at G=2, values exact, stream_ok; encode launch "
                f"{c['encode_ms']:.4f} ms, {c['decode_launches']} decode launches "
                f"{c['decode_ms']:.4f} ms (CUDA events), {c['gathers']} gathers {c['gather_ms']:.1f} ms "
                f"(host clock) {share}")
    tiled = ranks[0]["tiled"]
    log(f"  9.2 tiled analyze at {w}x{h}: max|dy| / max|y| = {tiled['analyze_rel']:.3g} "
        f"(rank 1: {ranks[1]['tiled']['analyze_rel']:.3g})")
    for (groups, q), run in tiled["runs"].items():
        enc_u, dec_u = untiled_ms[groups, q]
        log(f"  9.2 {'coder_mesh' if groups == 2 else 'groups=1'} q={q}: {run['bytes']} bytes "
            f"(untiled {run['untiled_bytes']}; {run['diff_bytes']} bytes and {run['diff_symbols']} "
            f"symbols differ), stream_ok, y_hat bit-exact, cross-decodes both ways; tiled encode "
            f"{run['encode_ms']:.1f} ms, decode {run['decode_ms']:.1f} ms (rank 0), untiled encode "
            f"{enc_u:.1f} ms, decode {dec_u:.1f} ms (one process) {share}")
    for shape in ((2, 1), (1, 2)):
        for r, res in enumerate(ranks):
            t = res["train"][shape]
            more = ", ".join(f"{ms:.1f}" for ms, _ in t["more"])
            log(f"  9.3 rank {r} mesh {shape}: loss {t['loss']:.6g} (one process {ref_loss:.6g}), worst "
                f"||dg||/||g|| {t['worst']:.3g} ({t['worst_name']}) over {t['n_params']} leaves; step "
                f"{t['first_ms']:.1f} ms" + (f", 3 more steps {more} ms" if more else "")
                + f"; resident parameters {t['resident']} bytes = {t['sharded_bytes']} sharded "
                f"(of {t['full_sharded_bytes']}, {t['n_shards']} leaves) + {t['replicated_bytes']} "
                f"replicated {share}")
            if shape == (1, 2):
                require(t["n_shards"] > 0 and 2 * t["sharded_bytes"] == t["full_sharded_bytes"]
                        and t["resident"] == t["sharded_bytes"] + t["replicated_bytes"],
                        f"mesh (1, 2) rank {r}: the sharded leaves are not held by halves")
    launches = tuple(sum(n) for n in zip(*(res["launches"] for res in ranks)))
    if nccl is not None:
        launches = tuple(a + b for a, b in zip(launches, nccl["launches"]))
        log(f"  9.4 one-rank NCCL group: allreduce_metrics, all_reduce, G=1 sharded encode and "
            f"decode == the encoder's, values exact, stream_ok; launches {nccl['launches']}")
    log(f"  phase 9 launches in the ranks (encode, decode): {launches}")
    return launches

# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

# the 12 flagship-table stages re-gridded: one CTA (1024), clusters of 8
# CTAs (2048, 4096, 8192), a cooperative grid of 16 CTAs (16384)
SPAN_LANES = (1024, 2048, 4096, 8192, 16384)
# K of the row / exchange split (a cluster of 8 CTAs up to K = 8192, then a
# grid of CTAs of up to 1,024); each C divides its K
SPAN_SPLITS = (1536, 2048, 4096, 8192, 16384)


def check_lane_counts(dev, smi):
    """Phase 10: the decode at every lane count the JAX coder takes.  The
    spanning kernels against their twins on the 12 flagship-table stages at
    K in SPAN_LANES and on three smaller stages at K in {48, 1056, 4100},
    and grouped at kt = 2048 and 1025; the row / exchange split; flagship
    round trips at K=2048 (batch 8, q=10), K=48 (batch 1, q=5) and K=16384
    (batch 8, q=10), the launches counted; `tools.bench_coder` over K in
    {512, 1024, 2048, 4096}.  Returns the `kernels` entries of the cluster
    and grid instances."""
    import contextlib
    import io

    from progressivecodec_tpu_torch.coder import rans_cuda
    from progressivecodec_tpu_torch.config import ModelConfig
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.tools import bench_coder

    model = seeded_model(ModelConfig(), dev)
    codec = GranularCodec(model, lanes=LANES, device=dev)
    codec.update()
    tables, row0 = codec._tables, codec.gauss_row0
    flag = flagship_stages(tables, row0, np.random.default_rng(SEED + 9))
    rows_of = stage_rows(codec, len(flag))
    cases = {k: decode_case(f"K={k}, 12 flagship-table stages", codec, flag, rows_of, k, dev, timed=True)
             for k in SPAN_LANES}
    small = flagship_stages(tables, row0, np.random.default_rng(SEED + 3))
    small = [small[0], small[1], tuple(a[:50_000] for a in small[-1])]
    for k in (48, 1056, 4100):
        decode_case(f"K={k}, z, one base slice, part of the enhancement", codec, small, stage_rows(codec, 3), k,
                    dev)
    decode_case("flagship-table stages", codec, flag, rows_of, 4096, dev, groups=2)
    decode_case("z, one base slice, part of the enhancement (kt=1025, staged)", codec, small,
                stage_rows(codec, 3), 4100, dev, groups=4)

    # the row and the exchange: a stream of C CTAs of w lanes against C
    # groups of K / C lanes, one CTA each, on the same grid (the same rows)
    for k in SPAN_SPLITS:
        c = rans_cuda.decode_span(k)[0]
        require(k % c == 0, f"split K={k}: {c} CTAs do not divide it into groups")
        log_split(scan_split(tables, codec.device_tables, row0, dev, groups=(1, c), lanes=k), f" K={k}")
    log_split(scan_split(tables, codec.device_tables, row0, dev, groups=(1,), lanes=1024), " K=1024")
    # two groups of 2,048 lanes: two clusters of 8 CTAs
    log_split(scan_split(tables, codec.device_tables, row0, dev, groups=(2,), lanes=4096), " K=4096")

    x1 = torch.from_numpy(synthetic_image(1, SEED)).to(dev)
    x8 = torch.from_numpy(synthetic_image(8, SEED + 1)).to(dev)
    launches = {}
    for k, x, q, route in ((2048, x8, 10, "cluster"), (48, x1, 5, None), (16384, x8, 10, "grid")):
        got = roundtrip(GranularCodec(model, lanes=k, device=dev), x, q, f"K={k} q={q} b={x.shape[0]}")
        span = {r: launches_since(r) for r in ("cluster", "grid")}
        want = {r: got["dec"] if r == route else 0 for r in span}
        require(span == want, f"K={k}: spanning launches {span}, want {want}")
        launches[k] = got["dec"]
        log(f"  K={k}: spanning decode launches {span}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_coder.main(["--lanes", "512,1024,2048,4096"])
    for line in buf.getvalue().splitlines():
        rec = json.loads(line)
        require(rec["values_exact"] and rec["stream_ok"] and rec["nvidia_smi"] == smi,
                f"bench_coder K={rec['lanes']}: {line}")
        log(f"  bench_coder: {line}")

    src = "progressivecodec_tpu_torch/csrc/rans_decode.cu"
    return [
        dict(name="rans_decode_scan", entry="cluster", route="cuda", source=src,
             replaces="progressivecodec_tpu/coder/rans_device.py:358", launches=launches[2048],
             library_ms=None, lanes=2048,
             **{key: cases[2048][key] for key in ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")}),
        dict(name="rans_decode_scan", entry="grid", route="cuda", source=src,
             replaces="progressivecodec_tpu/coder/rans_device.py:358", launches=launches[16384],
             library_ms=None, lanes=16384,
             **{key: cases[16384][key] for key in ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")}),
    ]


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------


class _Killed(Exception):
    """Stands in for a kill of the RD ladder between two points."""


def check_tools(dev, smi, run_dir):
    """Phase 11: the port's codec tools through their `main` on the card:
    `profile_codec` in both modes (flagship, 768x512, q=10, n=4),
    `bench_2k` (2048x1024, n=4), `rd_ladder` on phase 7's last checkpoint
    (`run_dir`) over the coarse grid and 2 SyntheticKodak images, killed
    after 5 points and resumed, `rem_flagship` on that checkpoint (10 bank
    steps, 2 images), `rem_demo` (20 base and 20 bank steps) and
    `bd_trajectory` on phase 7's metrics.jsonl.  The launches are zeroed
    before each tool and read after it.  Returns {tool: (encode, decode)
    launches}."""
    import os
    import tempfile

    from progressivecodec_tpu_torch.config import ModelConfig
    from progressivecodec_tpu_torch.tools import (
        bd_trajectory, bench_2k, profile_codec, rd_ladder, rem_demo, rem_flagship,
    )

    cfg = ModelConfig()
    launches = {}

    def run(name, fn):
        zero_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_launches()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s, launches (encode, decode) {launches[name]}")
        return out

    for mode in ("blocking", "trace"):
        rec = run(f"profile_codec {mode}", lambda: profile_codec.main(["--mode", mode, "--n", "4"]))
        require(rec["stream_ok"] and rec["y_hat_exact"] and rec["containers_equal_plain"]
                and rec["nvidia_smi"] == smi, f"profile_codec {mode}: {rec}")
        rows = rec["phases"]
        want = {"frag:analyze": 1, "frag:codec_base_step": 2 * (cfg.ns0 - 1),
                "coder:encode_scan_rev": 1, "coder:decode_stage_scan": 1 + cfg.ns0 + 1}
        got = {k: rows[k]["calls"] for k in want}
        require(got == want, f"profile_codec {mode}: calls per round trip {got}, want {want}")
        if mode == "trace":
            require(rec["device_events"] == rec["device_events_in_trace"] > 0,
                    f"profile_codec trace: {rec['device_events']} of "
                    f"{rec['device_events_in_trace']} device events charged to a phase")
            for k, n in (("coder:encode_scan_rev", 1), ("coder:decode_stage_scan", 12)):
                require(rows[k]["device_ms"] > 0 and rows[k]["events"] >= n, f"{k}: {rows[k]}")
            log(f"  profile_codec trace: device busy {rec['device_busy_ms']:.2f} ms, idle "
                f"{rec['idle_share_traced']:.3f} of the traced {rec['traced_round_trip_ms']:.1f} ms "
                f"and {rec['idle_share_untraced']:.3f} of the untraced "
                f"{rec['untraced_round_trip_ms']:.1f} ms round trip")

    rec = run("bench_2k", lambda: bench_2k.main(["--n", "4"]))
    require(rec["stream_ok"] and rec["nvidia_smi"] == smi, f"bench_2k: {rec}")
    require(rec["tiled_mesh1_bytes"] == rec["untiled_bytes"],
            f"bench_2k: one-rank tiled stream {rec['tiled_mesh1_bytes']} bytes, untiled "
            f"{rec['untiled_bytes']}")
    log(f"  bench_2k 2048x1024: untiled {rec['untiled_ms_per_image']:.1f} ms, tiled on one rank "
        f"{rec['tiled_mesh1_ms_per_image']:.1f} ms ({rec['halo_overhead_pct']:+.1f}%), "
        f"{rec['untiled_bytes']} bytes")

    ckpt = os.path.join(run_dir, "ckpt_last")
    with tempfile.TemporaryDirectory() as tmp:
        points = os.path.join(tmp, "points.jsonl")
        args = ["--checkpoint", ckpt, "--grid", "coarse", "--n-images", "2", "--out-jsonl", points,
                "--out", os.path.join(tmp, "rd.json")]
        evaluate, coded = rd_ladder.evaluate_codec, []

        def killed_after_5(*a, **kw):
            if len(coded) == 5:
                raise _Killed
            coded.append(evaluate(*a, **kw))
            return coded[-1]

        rd_ladder.evaluate_codec = killed_after_5
        try:
            rd_ladder.main(args)
            require(False, "rd_ladder was not killed")
        except _Killed:
            pass
        finally:
            rd_ladder.evaluate_codec = evaluate
        with open(points) as f:
            require(len(f.read().splitlines()) == 5, "rd_ladder: the killed run left no 5 points")
        res = run("rd_ladder resumed", lambda: rd_ladder.main(args))
        grid = rd_ladder.GRIDS["coarse"]
        require(res["coded_this_run"] == list(grid[5:]) and res["qualities"] == list(grid)
                and res["nvidia_smi"] == smi, f"rd_ladder resumed: {res}")
        want = (2 * 7, 2 * sum(1 + cfg.ns0 + (q > 0) for q in grid[5:]))
        require(launches["rd_ladder resumed"] == want,
                f"rd_ladder resumed: launches {launches['rd_ladder resumed']}, want {want}")
        log(f"  rd_ladder: bpp {[round(v, 4) for v in res['bpp']]}, BD-rate "
            f"{res['bd_rate_vs_fixed_pret']}, MS-SSIM max jump {res['ms_ssim_db_max_adjacent_jump']}")

        res = run("rem_flagship", lambda: rem_flagship.main(
            ["--checkpoint", ckpt, "--bank-steps", "10", "--n-images", "2",
             "--out", os.path.join(tmp, "rem_flagship.json")]))
        require(res["identity_at_init"] and res["frozen_unchanged"] and res["bank_tensors_moved"] > 0
                and res["nvidia_smi"] == smi, f"rem_flagship: {res}")
        log(f"  rem_flagship: delta {res['delta']}, bank loss {res['bank_loss_head_tail']}")

        env = {k: os.environ.get(k) for k in ("REM_DEMO_BASE_STEPS", "REM_DEMO_BANK_STEPS")}
        os.environ.update(REM_DEMO_BASE_STEPS="20", REM_DEMO_BANK_STEPS="20")
        try:
            res = run("rem_demo", lambda: rem_demo.main(["--out", os.path.join(tmp, "rem_demo.json")]))
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        require(res["identity_at_init"] and res["bank_tensors_moved"] > 0 and res["nvidia_smi"] == smi,
                f"rem_demo: {res}")
        log(f"  rem_demo: loss improvement vs base {res['loss_improvement_vs_base']:.4g}")

        rows = run("bd_trajectory", lambda: bd_trajectory.main(
            ["--run", run_dir, "--out", os.path.join(tmp, "bd.json")]))
        sweeps = sum("test" in r for r in _records(run_dir))
        require(len(rows) == sweeps, f"bd_trajectory: {len(rows)} rows for {sweeps} test sweeps")
    return launches


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

# g_s's four layers (Cin, Cout, input scale over the latent) of the flagship
# (M=320 into g_s, N=192), and the latents of the benchmark's images
GS_LAYERS = ((320, 192, 1), (192, 192, 2), (192, 192, 4), (192, 3, 8))
GS_LATENTS = {"768x512 b1": (1, 32, 48), "768x512 b8": (8, 32, 48), "2048x1024 b1": (1, 64, 128)}
# rel L2 of the kernel against cuDNN's F.conv_transpose2d in full float32:
# the same products summed in another order
DECONV_REL_L2 = 1e-5


def check_deconv(dev, smi):
    """Phase 12: g_s's transposed convolutions on `deconv2d_s2k5` against
    cuDNN's `F.conv_transpose2d` (TF32 off, deterministic), at ragged sizes
    and at every g_s layer of the benchmark's images, within rel L2
    DECONV_REL_L2; then one `deconv` line per layer shape: the kernel's
    CUDA-event ms, its float32 bound (the larger of the FLOPs at the card's
    float32 rate and the bytes at the HBM rate), the plain version's ms
    (`deconv2d_subpixel`, four stride-1 convolutions) and cuDNN's
    `F.conv_transpose2d` as `library_ms`, the yardstick.  Returns the
    lines."""
    import torch.nn.functional as F

    from progressivecodec_tpu_torch.device import set_deterministic
    from progressivecodec_tpu_torch.ops import deconv_cuda
    from progressivecodec_tpu_torch.utils.flops import chip_peak_flops

    set_deterministic()
    peak, note = chip_peak_flops(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def operands(b, cin, cout, h, w):
        x = torch.randn((b, cin, h, w), device=dev, generator=g)
        wt = torch.randn((cin, cout, 5, 5), device=dev, generator=g) / (5 * cin ** 0.5)
        return x, wt, torch.randn((cout,), device=dev, generator=g)

    def lib(x, wt, bias):
        return F.conv_transpose2d(x, wt, bias, stride=2, padding=2, output_padding=1)

    def check(label, x, wt, bias):
        got = deconv_cuda.deconv2d_s2k5(x, wt, bias)
        want = lib(x, wt, bias)
        torch.cuda.synchronize()
        err = float((got - want).norm() / want.norm())
        require(bool(torch.isfinite(got).all()) and err <= DECONV_REL_L2,
                f"deconv {label}: rel L2 {err:.3g} > {DECONV_REL_L2}")
        return err

    for b, cin, cout, h, w in ((1, 20, 16, 5, 7), (2, 9, 3, 33, 17), (1, 13, 40, 17, 33),
                               (3, 192, 192, 9, 20), (1, 1, 1, 1, 1)):
        err = check(f"ragged {(b, cin, cout, h, w)}", *operands(b, cin, cout, h, w))
        log(f"  deconv ragged x {(b, cin, h, w)} Cout {cout} ({deconv_cuda.plan(cout)}): "
            f"rel L2 {err:.3g}")

    lines = []
    for image, (b, h0, w0) in GS_LATENTS.items():
        for layer, (cin, cout, sc) in enumerate(GS_LAYERS):
            h, w = h0 * sc, w0 * sc
            x, wt, bias = operands(b, cin, cout, h, w)
            err = check(f"{image} layer {layer}", x, wt, bias)
            macs = deconv_cuda.macs(b, cin, cout, h, w)
            nbytes = 4 * (x.numel() + wt.numel() + cout + 4 * b * cout * h * w)
            bound_ms = 1e3 * max(2 * macs / peak, nbytes / MEM_BYTES_PER_S)
            reps = max(3, min(50, int(2e11 / macs)))
            kernel_ms = cuda_time_ms(lambda: deconv_cuda.deconv2d_s2k5(x, wt, bias), reps)
            plain_ms = cuda_time_ms(lambda: deconv_cuda.deconv2d_subpixel(x, wt, bias), reps)
            library_ms = cuda_time_ms(lambda: lib(x, wt, bias), reps)
            line = dict(image=image, layer=layer, batch=b, cin=cin, cout=cout, h=h, w=w,
                        instance=deconv_cuda.plan(cout),
                        ctas=deconv_cuda.grid_ctas(deconv_cuda.plan(cout), b, cout, h, w),
                        gmac=macs / 1e9, rel_l2=err, kernel_ms=kernel_ms, bound_ms=bound_ms,
                        roofline=bound_ms / kernel_ms, plain_ms=plain_ms, library_ms=library_ms)
            log("deconv " + json.dumps(line))
            lines.append(line)
    for image in GS_LATENTS:
        rows = [r for r in lines if r["image"] == image]
        k, lb, p = (sum(r[f] for r in rows) for f in ("kernel_ms", "bound_ms", "library_ms"))
        log(f"  deconv {image}, g_s's four layers: kernel {k:.3f} ms, bound {lb:.3f} ms "
            f"({100 * lb / k:.1f}% of {note}), cuDNN {p:.3f} ms, on {smi}")
    return lines


def seeded_model(cfg, dev, seed=SEED):
    from progressivecodec_tpu_torch.models.registry import get_model
    from progressivecodec_tpu_torch.models.weights import init_params

    model = get_model(cfg, device=dev)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(seed)), strict=True)
    return model


_AB_JOB = """
import importlib.util, json, sys
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke_ab", "chip_smoke.py")
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
from progressivecodec_tpu_torch import build
build.build()
dev = torch.device("cuda")
tables = m.flagship_tables(dev)
for k in json.loads(sys.argv[1]) or [None]:
    split = m.scan_split(*tables, dev) if k is None else m.scan_split(*tables, dev, groups=(1,), lanes=k)
    print(f"SPLIT {k} " + json.dumps(split))
"""


def ab_split(others, lanes=()) -> None:
    """`scan_split` of other checkouts of the repo (e.g. the parent commit
    unpacked by `git archive` into build/) against this one, one process
    each, in the order others, this, this, others reversed, on one card;
    each runs its own chip_smoke.py against its own package and builds its
    own kernels.  With `lanes`, the single stream at each
    of those K instead of the flagship's G in {1, 2, 4, 16}."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    order = [("other", o) for o in others] + [("this", here)] * 2 + [("other", o) for o in others[::-1]]
    for label, tree in order:
        out = subprocess.run([sys.executable, "-c", _AB_JOB, json.dumps(list(lanes))],
                             cwd=tree, capture_output=True, text=True, timeout=900)
        require(out.returncode == 0, f"split of {tree} failed:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        for line in out.stdout.splitlines():
            if line.startswith("SPLIT "):
                _, k, body = line.split(" ", 2)
                log_split({int(g): r for g, r in json.loads(body).items()},
                          f" [{label}: {tree}]" + ("" if k == "None" else f" K={k}"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--deconv"]:
        from progressivecodec_tpu_torch import build

        smi = nvidia_smi_line()
        log(f"nvidia-smi: {smi}")
        for line in build.build(["deconv"])["deconv"].splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                log(f"  deconv: {line.strip()}")
        check_deconv(torch.device("cuda"), smi)
        return 0
    if sys.argv[1:2] == ["--ab"]:
        log(f"nvidia-smi: {nvidia_smi_line()}")
        others, lanes = sys.argv[2:], ()
        if others[:1] == ["--lanes"]:
            lanes, others = tuple(int(k) for k in others[1].split(",")), others[2:]
        ab_split(others, lanes)
        return 0

    from progressivecodec_tpu_torch import build
    from progressivecodec_tpu_torch.config import ModelConfig
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    log("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"  device: {kind}, count {count}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    log("phase 2: build")
    t0 = time.perf_counter()
    reports = build.build()
    log(f"  built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 3: kernels vs plain twins")
    cfg = ModelConfig()
    t0 = time.perf_counter()
    model = seeded_model(cfg, dev)
    codec = GranularCodec(model, lanes=LANES)
    codec.update()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  flagship model {n_params} parameters, tables built in {time.perf_counter() - t0:.1f} s")
    results = check_kernels(codec, dev)
    check_decode_cases(codec, dev)
    grouped_results = check_grouped_cases(codec, dev)

    log("phase 4: main paths at 768x512")
    log("  flagship ModelConfig(), one stream")
    x1 = torch.from_numpy(synthetic_image(1, SEED)).to(dev)
    roundtrip(codec, x1, 10, "warm-up q=10 b=1")
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    for q in (0, 5, 10):
        counts[q] = roundtrip(codec, x1, q, f"q={q} b=1")
    main_counts = counts[10]
    x8 = torch.from_numpy(synthetic_image(8, SEED + 1)).to(dev)
    roundtrip(codec, x8, 10, "q=10 b=8")
    latent = 80.0 * torch.randn((1, H // 16, W // 16, cfg.M), generator=torch.Generator().manual_seed(SEED),
                                dtype=torch.float32)
    esc = roundtrip(codec, x1, 10, "80x-normal latent q=10", latent=latent.to(dev))
    require(esc["esc"] > 0, "80x-normal latent produced no escapes")

    log(f"  flagship ModelConfig(), PCT1-G: groups=4 at K={LANES} (kt={LANES // 4})")
    grouped = GranularCodec(model, lanes=LANES, groups=4)
    roundtrip(grouped, x1, 10, "groups=4 warm-up q=10 b=1")
    for q in (0, 10):
        got = roundtrip(grouped, x1, q, f"groups=4 q={q} b=1", want_y_hat=counts[q]["y_hat"])
    grouped_counts = got
    del grouped

    log("  reference CLI default ModelConfig(multiple_decoder=False, stack_prog=False): unrolled")
    cli = GranularCodec(seeded_model(ModelConfig(multiple_decoder=False, stack_prog=False), dev), lanes=LANES)
    roundtrip(cli, x1, 10, "unrolled warm-up q=10 b=1")
    for q in (0, 10):
        roundtrip(cli, x1, q, f"unrolled q={q} b=1")
    del cli

    log("  WACNN ModelConfig(name='cnn', M=320)")
    wacnn = GranularCodec(seeded_model(ModelConfig(name="cnn", M=320), dev), lanes=LANES)
    roundtrip(wacnn, x1, 0, "WACNN warm-up q=0 b=1")
    roundtrip(wacnn, x1, 0, "WACNN q=0 b=1")
    del wacnn

    log("phase 5: REM ModelConfig(name='rate'), live banks, and the escalation cascade")
    check_rem(dev, x1, ModelConfig(name="rate"))

    log("phase 6: the eval path on the flagship ModelConfig()")
    check_eval(codec)
    del codec, model
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("phase 7: training the flagship ModelConfig() at TrainConfig() defaults")
    import atexit
    import shutil
    import tempfile

    kept = tempfile.mkdtemp(prefix="chip_smoke_kept_")  # phase 7's run, for phase 11
    atexit.register(shutil.rmtree, kept, ignore_errors=True)
    run_dir = f"{kept}/run"
    train_enc, train_dec = check_training(dev, smi, keep=run_dir)

    log("phase 8: importance masks, rd_sweep, profiling")
    t0 = time.perf_counter()
    map_launches, rd_launches = check_importance(dev, x1, smi)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    log("phase 9: parallel/, two ranks on the card (gloo), then a one-rank NCCL group")
    del x1
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = check_parallel(dev, smi)
    require(all(n > 0 for n in sharded), f"a kernel was not launched in phase 9's ranks: {sharded}")
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")

    log("phase 10: every lane count: streams and groups spanning CTAs, round trips, bench_coder")
    t0 = time.perf_counter()
    spanning = check_lane_counts(dev, smi)
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")

    log("phase 11: the codec tools on the card")
    t0 = time.perf_counter()
    tool_launches = check_tools(dev, smi, run_dir)
    log(f"  phase 11 launches per tool (encode, decode): {tool_launches}")
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")

    log("phase 12: g_s's transposed convolutions")
    deconv_lines = check_deconv(dev, smi)

    kernels = [
        dict(name="rans_encode_scan", route="cuda",
             source="progressivecodec_tpu_torch/csrc/rans_encode.cu",
             replaces="progressivecodec_tpu/coder/rans_pallas.py:117",
             launches=main_counts["enc"], library_ms=None, train_eval_launches=train_enc,
             cust_map_launches=map_launches[0], rd_sweep_launches=rd_launches[0],
             sharded_launches=sharded[0], tools_launches={k: v[0] for k, v in tool_launches.items()},
             **results["rans_encode_scan"]),
        dict(name="rans_decode_scan", entry="stream", route="cuda",
             source="progressivecodec_tpu_torch/csrc/rans_decode.cu",
             replaces="progressivecodec_tpu/coder/rans_device.py:358",
             launches=main_counts["dec"], library_ms=None, train_eval_launches=train_dec,
             cust_map_launches=map_launches[1], rd_sweep_launches=rd_launches[1],
             sharded_launches=sharded[1], tools_launches={k: v[1] for k, v in tool_launches.items()},
             **results["rans_decode_scan"]),
        dict(name="rans_decode_scan", entry="grouped", route="cuda",
             source="progressivecodec_tpu_torch/csrc/rans_decode.cu",
             replaces="progressivecodec_tpu/coder/rans_device.py:555",
             launches=grouped_counts["dec"], library_ms=None, **grouped_results),
    ] + spanning + [
        dict(name="deconv2d_s2k5", route="cuda", source="progressivecodec_tpu_torch/csrc/deconv.cu",
             replaces=None, launches=main_counts["deconv"], **line) for line in deconv_lines
    ]
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
