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
     path); then the PCT1-G grouped decode kernel on the flagship-table
     stages at (K, G) = (512, 4) and (512, 16) and on smaller stages at
     (32, 4), (1024, 2), (64, 64) and (96, 3), escapes included;
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
     stage, on the grouped kernel when groups > 1;
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
     memory, checkpoint bytes and save seconds.
The last line is {"ok": true, "device": {...}}; the line before it is the
`kernels` JSON object, whose encode and decode entries carry
`train_eval_launches`, the launches of phase 7's real-codec evals.
"""

from __future__ import annotations

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


def decode_wrapper_floor(dev, passes=9, lanes=LANES):
    """The decode wrapper's host floor: the 12 decode launches of a round
    trip with no rows, so the kernel returns at once and the CUDA-event time
    is the host's.  Returns the ms for all 12 in each of `passes` passes.
    It builds the flagship's coder tables without a model (a seeded
    EntropyBottleneck(N) and the Gaussian rows), so it runs against any
    checkout's package, to compare two of them."""
    from progressivecodec_tpu_torch.coder import rans_device
    from progressivecodec_tpu_torch.coder.tables import merge_tables
    from progressivecodec_tpu_torch.config import ModelConfig
    from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck, build_bottleneck_tables
    from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables

    cfg = ModelConfig()
    eb = EntropyBottleneck(cfg.N, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(SEED))
    merged, _ = merge_tables(build_bottleneck_tables(eb.host_params()),
                             build_gaussian_tables(cfg.scale_table.values()))
    t = rans_device.DeviceTables.from_tables(merged, dev)
    stream = torch.zeros(2 * lanes, dtype=torch.int16, device=dev)
    dec0 = rans_device.decoder_init(stream, lanes)
    ig = torch.zeros((0, lanes), dtype=torch.int32, device=dev)
    kg = torch.zeros((0, lanes), dtype=torch.uint8, device=dev)

    def run():
        for _ in range(12):
            rans_device.decode_stage_scan(dec0, stream, ig, kg, t, lanes)

    return [cuda_time_ms(run, reps=20) for _ in range(passes)]


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
    stream, n_words, esc, n_esc = rans_device.encode_finalize(*got, esc_flags, sym, LANES)
    stream = stream[: int(n_words)]
    esc = torch.cat([esc[: 2 * int(n_esc)], torch.zeros(2, dtype=torch.int16, device=dev)])
    log(f"  flagship-table stream: {int(n_words)} words, {int(n_esc)} escapes")

    grids = []
    for s_sym, s_idx, s_keep in dev_stages:
        grids.append((rans_device._pad_to_grid(s_idx, LANES),
                      rans_device._pad_to_grid(s_keep.to(torch.uint8), LANES)))
    rows_of = stage_rows(codec, len(grids))
    dec_err = 0
    dec0 = rans_device.decoder_init(stream, LANES)
    dec = dec0
    kept = 0
    for (s_sym, s_idx, s_keep), (ig, kg), rows in zip(dev_stages, grids, rows_of):
        got = rans_cuda.rans_decode_scan(dec.states, dec.offset, stream, ig, kg, t.dec_sf,
                                         t.compact, rows)
        torch.cuda.synchronize()
        want = rans_cuda.rans_decode_scan_plain(dec.states, dec.offset, stream, ig, kg, t.dec_sf)
        err = max_abs_err(got, want)
        require(err == 0, f"decode kernel != plain twin: max|d| {err}")
        dec_err = max(dec_err, err)
        esc_off, vals = rans_device.decode_stage_values(
            dec.esc_offset, got[2], esc, s_idx, s_keep, t, LANES
        )
        require(torch.equal(vals, torch.where(s_keep, s_sym, 0)), "decoded values != symbols")
        dec = rans_device.DecoderState(got[0], got[1], esc_off)
        kept += int(s_keep.sum())
    require(bool(rans_device.stream_ok(dec)), "flagship-table stream: stream_ok is False")
    require(int(dec.offset) == int(n_words), "decoder did not consume the whole payload")
    log(f"  decode scan, 12 flagship-table stages: kernel == plain twin, values exact, stream_ok")

    def dec_all(plain):
        d = dec0
        for (ig, kg), rows in zip(grids, rows_of):
            if plain:
                s, o, _ = rans_cuda.rans_decode_scan_plain(d.states, d.offset, stream, ig, kg, t.dec_sf)
            else:
                s, o, _ = rans_cuda.rans_decode_scan(d.states, d.offset, stream, ig, kg, t.dec_sf,
                                                     t.compact, rows)
            d = rans_device.DecoderState(s, o, d.esc_offset)

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
    require(int(ref[1]) == int(out[1]) and torch.equal(ref[0][: int(ref[1])], out[0][: int(out[1])].cpu()),
            "small stream: card != CPU reference")
    log("  small stream (3 stages, 64 lanes): card kernels == CPU plain twins, byte for byte")

    cells = 1956 * LANES
    consumed = int(n_words) - 2 * LANES
    enc_bytes = cells * (4 + 1 + 2 + 1) + 4 * LANES
    enc_ops = cells * 30  # renorm test, shifts, masks and the magic-multiplier divmod
    # each stage reads its CDF rows' compact table once (starts and buckets)
    table_bytes = 0
    for rows in rows_of:
        plan = rans_cuda.plan_decode(t.compact, rows, LANES, rans_cuda._smem_optin(0))
        table_bytes += 2 * plan.span_len + 2 * plan.nrows * plan.bucket_stride + 8 * plan.nrows
    dec_bytes = cells * (4 + 1 + 4) + table_bytes + consumed * 2 + 12 * 8 * LANES
    dec_ops = cells * 12
    results["rans_encode_scan"] = dict(
        ms=enc_ms, plain_ms=enc_plain_ms, max_abs_err=enc_err,
        bound_ms=1e3 * max(enc_bytes / MEM_BYTES_PER_S, enc_ops / INT32_OPS_PER_S),
        bound_by="bytes" if enc_bytes / MEM_BYTES_PER_S >= enc_ops / INT32_OPS_PER_S else "operations",
    )
    results["rans_decode_scan"] = dict(
        ms=dec_ms, plain_ms=dec_plain_ms, max_abs_err=dec_err,
        bound_ms=1e3 * max(dec_bytes / MEM_BYTES_PER_S, dec_ops / INT32_OPS_PER_S),
        bound_by="bytes" if dec_bytes / MEM_BYTES_PER_S >= dec_ops / INT32_OPS_PER_S else "operations",
    )
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms ({1e6 * r['ms'] / 1956:.1f} ns per row), "
            f"plain twin {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return results


def decode_case(label, codec, stages, rows_of, lanes, dev, smem_cap=None, want_ok=True):
    """Code `stages` on the card (encode kernel vs twin), then decode every
    stage with the decode kernel and its twin; all bit for bit.  Returns
    (rows decoded, kernel ms for all stages)."""
    from progressivecodec_tpu_torch.coder import rans_cuda, rans_device

    t = codec.device_tables
    dstages = [tuple(a.to(dev) for a in s) for s in stages]
    sf_rev, kp_rev, esc_flags, sym = rans_device.encode_prepare(dstages, t, lanes)
    enc = rans_cuda.rans_encode_scan(sf_rev, kp_rev)
    torch.cuda.synchronize()
    err = max_abs_err(enc, rans_cuda.rans_encode_scan_plain(sf_rev, kp_rev))
    require(err == 0, f"{label}: encode kernel != plain twin: max|d| {err}")
    stream, n_words, _, _ = rans_device.encode_finalize(*enc, esc_flags, sym, lanes)
    stream = stream[: int(n_words)]
    grids = [(rans_device._pad_to_grid(s_idx, lanes),
              rans_device._pad_to_grid(s_keep.to(torch.uint8), lanes)) for _, s_idx, s_keep in dstages]
    dec0 = rans_device.decoder_init(stream, lanes)
    dec = dec0
    for (ig, kg), rows in zip(grids, rows_of):
        got = rans_cuda.rans_decode_scan(dec.states, dec.offset, stream, ig, kg, t.dec_sf,
                                         t.compact, rows, smem_cap=smem_cap)
        torch.cuda.synchronize()
        want = rans_cuda.rans_decode_scan_plain(dec.states, dec.offset, stream, ig, kg, t.dec_sf)
        err = max_abs_err(got, want)
        require(err == 0, f"{label}: decode kernel != plain twin: max|d| {err}")
        dec = rans_device.DecoderState(got[0], got[1], dec.esc_offset)
    if want_ok:
        require(bool(rans_device.stream_ok(dec)) and int(dec.offset) == int(n_words),
                f"{label}: stream_ok is False")

    def run():
        d = dec0
        for (ig, kg), rows in zip(grids, rows_of):
            s, o, _ = rans_cuda.rans_decode_scan(d.states, d.offset, stream, ig, kg, t.dec_sf,
                                                 t.compact, rows, smem_cap=smem_cap)
            d = rans_device.DecoderState(s, o, d.esc_offset)

    n_rows = sum(ig.shape[0] for ig, _ in grids)
    ms = cuda_time_ms(run, reps=3, warmup=1)
    per_row = f"{1e6 * ms / n_rows:.1f} ns per row" if n_rows else "no rows"
    log(f"  decode case {label}: P={n_rows} K={lanes}, {int(n_words)} words: encode and decode "
        f"kernels == plain twins, stream_ok; decode {ms:.4f} ms ({per_row})")
    return n_rows, ms


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
    rows8, ms8 = decode_case("batch-8 flagship grid", codec, b8, stage_rows(codec, len(b8)),
                             LANES, dev)
    require(rows8 == 15_648, f"batch-8 grid has {rows8} rows, want 15,648")
    flag3 = flagship_stages(tables, row0, np.random.default_rng(SEED + 5))[:3]
    cap = max(rans_cuda.decode_smem_bytes(LANES, 1, 0, 0, plan.ring_words, False)
              for plan in [rans_cuda.plan_decode(t.compact, gauss, LANES, 1 << 30)])
    for rows in stage_rows(codec, 3):
        require(not rans_cuda.plan_decode(t.compact, rows, LANES, cap).table_in_smem,
                "the global-table case did not select the global-table path")
    decode_case("global-table path (rings-only shared memory), z and two base slices", codec,
                flag3, stage_rows(codec, 3), LANES, dev, smem_cap=cap)


def grouped_case(label, codec, stages, rows_of, lanes, groups, dev, timed=True):
    """Code `stages` as PCT1-G on the card (the encode kernel over all lanes,
    per-group compaction), then decode every stage with the grouped kernel
    and its twin, bit for bit, and check the values and stream_ok.  Returns
    (rows, payload words consumed, kernel ms for all stages, twin ms for all
    stages)."""
    from progressivecodec_tpu_torch.coder import rans_cuda, rans_device

    t = codec.device_tables
    dstages = [tuple(a.to(dev) for a in s) for s in stages]
    streams, n_words, escs, n_escs = rans_device.encode_stages_grouped(dstages, t, lanes, groups)
    escs = torch.nn.functional.pad(escs, (0, 2))
    grids = [(rans_device._pad_to_grid(s_idx, lanes),
              rans_device._pad_to_grid(s_keep.to(torch.uint8), lanes)) for _, s_idx, s_keep in dstages]
    dec0 = rans_device.grouped_decoder_init(streams, lanes, groups)
    dec = dec0
    for (s_sym, s_idx, s_keep), (ig, kg), rows in zip(dstages, grids, rows_of):
        got = rans_cuda.rans_decode_scan_grouped(dec.states, dec.offsets, streams, ig, kg, t.dec_sf,
                                                 t.compact, rows)
        torch.cuda.synchronize()
        want = rans_cuda.rans_decode_scan_grouped_plain(dec.states, dec.offsets, streams, ig, kg, t.dec_sf)
        err = max_abs_err(got, want)
        require(err == 0, f"{label}: grouped decode kernel != plain twin: max|d| {err}")
        esc_off, vals = rans_device.decode_stage_grouped_values(
            dec.esc_offsets, got[2], escs, s_idx, s_keep, t, lanes, groups)
        require(torch.equal(vals, torch.where(s_keep, s_sym, 0)), f"{label}: decoded values != symbols")
        dec = rans_device.GroupedDecoderState(got[0], got[1], esc_off)
    require(bool(rans_device.grouped_stream_ok(dec)) and torch.equal(dec.offsets, n_words.to(torch.int32)),
            f"{label}: stream_ok is False")

    def run(plain):
        d = dec0
        for (ig, kg), rows in zip(grids, rows_of):
            if plain:
                s, o, _ = rans_cuda.rans_decode_scan_grouped_plain(d.states, d.offsets, streams, ig, kg,
                                                                   t.dec_sf)
            else:
                s, o, _ = rans_cuda.rans_decode_scan_grouped(d.states, d.offsets, streams, ig, kg,
                                                             t.dec_sf, t.compact, rows)
            d = rans_device.GroupedDecoderState(s, o, d.esc_offsets)

    n_rows = sum(ig.shape[0] for ig, _ in grids)
    ms = cuda_time_ms(lambda: run(False), reps=10 if timed else 3, warmup=1)
    plain_ms = cuda_time_ms(lambda: run(True), reps=1, warmup=0) if timed else None
    plan = rans_cuda.plan_decode(t.compact, rows_of[-1], rans_cuda.warp_lanes(lanes // groups),
                                 rans_cuda._smem_optin(0))
    log(f"  decode case grouped {label}: P={n_rows} K={lanes} G={groups} (kt={lanes // groups}), "
        f"{int(n_words.sum())} words, {int(n_escs.sum())} escapes: grouped kernel == plain twin, values "
        f"exact, stream_ok; decode {ms:.4f} ms ({1e6 * ms / n_rows:.1f} ns per row), "
        f"{plan.smem_bytes} B shared memory per CTA")
    return n_rows, int(n_words.sum()) - 2 * lanes, ms, plain_ms


def check_grouped_cases(codec, dev):
    """Phase 3, third part: the PCT1-G decode kernel against its twin.
    Returns the kernel-table entry, measured on the flagship-table stages at
    K=512, G=4 (kt=128), the grouped flagship round trip's shape."""
    from progressivecodec_tpu_torch.coder import rans_cuda

    tables = codec._tables
    row0 = codec.gauss_row0
    flag = flagship_stages(tables, row0, np.random.default_rng(SEED + 7))
    rows_of = stage_rows(codec, len(flag))
    n_rows, consumed, ms, plain_ms = grouped_case("flagship-table stages", codec, flag, rows_of,
                                                  LANES, 4, dev)
    grouped_case("flagship-table stages", codec, flag, rows_of, LANES, 16, dev, timed=False)
    small = flagship_stages(tables, row0, np.random.default_rng(SEED + 8))
    small = [small[0], small[1], tuple(a[:50_000] for a in small[-1])]
    for lanes, groups in ((32, 4), (1024, 2), (64, 64), (96, 3)):
        grouped_case("z, one base slice, part of the enhancement", codec, small, stage_rows(codec, 3),
                     lanes, groups, dev, timed=False)
    # the bytes, as for the single stream: idx, keep and cums per cell, each
    # stage's compact table once, the payload words consumed, the states
    # and the four offsets in and out of each stage
    cells = n_rows * LANES
    table_bytes = 0
    for rows in rows_of:
        plan = rans_cuda.plan_decode(codec.device_tables.compact, rows, 128, rans_cuda._smem_optin(0))
        table_bytes += 2 * plan.span_len + 2 * plan.nrows * plan.bucket_stride + 8 * plan.nrows
    dec_bytes = cells * (4 + 1 + 4) + table_bytes + consumed * 2 + 12 * (8 * LANES + 8 * 4)
    dec_ops = cells * 12
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=0,
                bound_ms=1e3 * max(dec_bytes / MEM_BYTES_PER_S, dec_ops / INT32_OPS_PER_S),
                bound_by="bytes" if dec_bytes / MEM_BYTES_PER_S >= dec_ops / INT32_OPS_PER_S else "operations")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def synthetic_image(batch: int, seed: int):
    """Seeded natural-looking 768x512 images in [0, 1], NHWC float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(batch):
        f = rng.uniform(0.005, 0.03, (3, 2))
        ph = rng.uniform(0, 2 * np.pi, (3, 2))
        img = np.stack([0.5 + 0.25 * np.sin(f[c, 0] * xx + ph[c, 0]) * np.cos(f[c, 1] * yy + ph[c, 1])
                        for c in range(3)], axis=-1)
        img += 0.05 * rng.standard_normal((H, W, 3)).astype(np.float32)
        out.append(np.clip(img, 0.0, 1.0))
    return np.stack(out).astype(np.float32)


def zero_launches():
    from progressivecodec_tpu_torch.coder import rans_cuda

    for scan in (rans_cuda.rans_encode_scan, rans_cuda.rans_decode_scan,
                 rans_cuda.rans_decode_scan_grouped):
        scan.launches = 0


def read_launches():
    """(encode, decode, grouped decode) launches since `zero_launches`."""
    from progressivecodec_tpu_torch.coder import rans_cuda

    return (rans_cuda.rans_encode_scan.launches, rans_cuda.rans_decode_scan.launches,
            rans_cuda.rans_decode_scan_grouped.launches)


def roundtrip(codec, x, q, label, *, latent=None, want_y_hat=None):
    """One checked round trip; the launch counts are zeroed just before it
    and read just after it.  Returns the counts, the escape words and y_hat."""
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if latent is None:
        data = codec.compress(x, quality=q, simulate=True)
    else:
        data = codec.compress_from_latent(latent, x.shape, quality=q, simulate=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blob = codec.serialize(data)
    back = codec.deserialize(blob)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = codec.decompress(back)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    enc_n, dec_n, grp_n = read_launches()

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
    got = (dec_n, grp_n) if codec.groups == 1 else (grp_n, dec_n)
    require(got == (want_dec, 0), f"{label}: {got} (decode, grouped decode) launches, want {want_dec}")
    n_esc = sum(len(e) for e in back["escs"]) if codec.groups > 1 else len(back["esc"])
    bpp = 8 * len(blob) / (b * H * W)
    log(f"  {label}: {len(blob)} bytes ({bpp:.4f} bpp), {n_esc // 2} escapes, "
        f"encode {1e3 * (t1 - t0):.1f} ms, decode {1e3 * (t3 - t2):.1f} ms, launches encode={enc_n} "
        f"decode={dec_n} grouped decode={grp_n}, stream_ok, y_hat bit-exact")
    return {"enc": enc_n, "dec": dec_n, "grouped": grp_n, "esc": n_esc, "y_hat": out["y_hat"]}


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
    want = (n_levels, n_levels * (1 + cfg.ns0 + cfg.num_prog_slices), 0)
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
    want = (len(qualities) * n_images, n_dec, 0)
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


def check_training(dev, smi):
    """Phase 7: `cli.train` on the flagship ModelConfig() at TrainConfig()
    defaults (batch 16, patch 256), 2 epochs of 4 steps, then a resume to
    epoch 3, then `cli.eval --checkpoint` on its last checkpoint, then one
    step on the card against the same step on the CPU.  Returns the encode
    and decode launches counted during the trainer's real-codec evals."""
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
        want = (6, 2 * sum(1 + cfg.ns0 + (q > 0) for q in (0.0, 1.0, 10.0)), 0)
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
    log(f"  real-codec eval launches per epoch (encode, decode, grouped): {eval_launches}")
    log(f"  cli.eval --checkpoint: real bpp {result['real_codec']['bpp']} = the trainer's last, "
        f"{t4 - t3:.1f} s")
    split_step(dev)
    card_vs_cpu(dev)
    log(f"  phase 7 on {smi}")
    return tuple(sum(n[i] for n in eval_launches) for i in range(2))


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


def seeded_model(cfg, dev, seed=SEED):
    from progressivecodec_tpu_torch.models.registry import get_model
    from progressivecodec_tpu_torch.models.weights import init_params

    model = get_model(cfg, device=dev)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(seed)), strict=True)
    return model


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2

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
    results["rans_decode_scan_grouped"] = check_grouped_cases(codec, dev)

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
    train_enc, train_dec = check_training(dev, smi)

    kernels = [
        dict(name="rans_encode_scan", route="cuda",
             source="progressivecodec_tpu_torch/csrc/rans_encode.cu",
             replaces="progressivecodec_tpu/coder/rans_pallas.py:117",
             launches=main_counts["enc"], library_ms=None, train_eval_launches=train_enc,
             **results["rans_encode_scan"]),
        dict(name="rans_decode_scan", route="cuda",
             source="progressivecodec_tpu_torch/csrc/rans_decode.cu",
             replaces="progressivecodec_tpu/coder/rans_device.py:358",
             launches=main_counts["dec"], library_ms=None, train_eval_launches=train_dec,
             **results["rans_decode_scan"]),
        dict(name="rans_decode_scan_grouped", route="cuda",
             source="progressivecodec_tpu_torch/csrc/rans_decode.cu",
             replaces="progressivecodec_tpu/coder/rans_device.py:555",
             launches=grouped_counts["grouped"], library_ms=None,
             **results["rans_decode_scan_grouped"]),
    ]
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
