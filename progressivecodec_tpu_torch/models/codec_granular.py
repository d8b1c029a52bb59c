"""Granular codec: compress / decompress through shared model fragments.

Counterpart of `progressivecodec_tpu/models/codec_granular.py` for
ChannelProgressiveWACNN (stacked and unrolled enhancement), its REM
subclass (`models/rem.py`, whose cascade passes `checkpoint_rep`), and the
single-rate WACNN, STF and TCM (`models/stf.py`, `models/tcm.py`, which the
JAX package lacks), on one stream or on G independent sub-streams (PCT1-G,
`groups`).  z's channel count is the model's entropy bottleneck's (N, but
192 for TCM).

The decoder re-derives every CDF index and the enhancement mask from
sigma, so sigma must have the same bits on the encode and the decode side.
Both sides therefore run the same model fragments (`codec_*` methods of
the model) on the same shapes, with one `_base_loop` for both, and the
codec sets, process-wide (`device.set_deterministic`):
  * torch.backends.cudnn.allow_tf32 = False (its default is True);
  * torch.backends.cuda.matmul.allow_tf32 = False;
  * torch.backends.cudnn.deterministic = True;
  * torch.backends.cudnn.benchmark = False.
Encode and decode must use the same batch shape.

The rANS scans run as CUDA kernels on the card (`coder/rans_cuda.py`):
one encode-scan launch per `compress`, one decode-scan launch per stage of
`decompress` (z, each base slice, then the stacked enhancement stage or
one stage per unrolled enhancement slice when quality > 0), over every
group.  The one-stream container is PCT1-G at one group: the coder takes
one path, from the container dict's G `streams` and `escs` down to the
decode wrapper, for every G.  With a `coder_mesh`
(parallel/sharded_coder.py) each rank of the mesh axis makes those
launches for its own lane group: an encode launch over its kt lanes, and
per stage a decode launch of its one group.

The unrolled enhancement's quality-independent networks (each slice's
parameter networks, its refinement banks, its reconstruction tail) run as
CUDA graphs on the card, captured on a latent shape's second loop and
replayed after (`models/graphs.py`, `self.graphs`); the masks, indexes and
the coder stay eager.  Weights loaded anew (`load_state_dict`) or tables
built anew (`update`) drop the graphs.

Each public call is a `codec:*` span (`utils/profiling.py`); inside it the
codec's own steps between the model's fragments are `glue:*` spans and the
points where the host waits on the card `sync:*` spans.  `compress` counts
the container's payload words (`words:payload`, the lane-state head
included) and escape words (`words:escape`).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from progressivecodec_tpu_torch.coder import rans_device
from progressivecodec_tpu_torch.coder.rans_device import DecoderState, _pad_to_grid
from progressivecodec_tpu_torch.coder.tables import DEFAULT_LANES, check_lanes
from progressivecodec_tpu_torch.device import resolve_device, set_deterministic
from progressivecodec_tpu_torch.models import graphs
from progressivecodec_tpu_torch.models.codec import Codec, _stream_capacity
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN, unstack_channels
from progressivecodec_tpu_torch.models.wacnn import SingleRateFragments
from progressivecodec_tpu_torch.parallel.sharded_coder import (
    sharded_decode_stage,
    sharded_encode_stages,
)
from progressivecodec_tpu_torch.utils.profiling import count, span

F32 = torch.float32
I32 = torch.int32


class GranularCodec(Codec):
    """Codec with per-stage shared fragments for the port's model families."""

    def __init__(self, model, lanes: int = DEFAULT_LANES, groups: int = 1, coder_mesh=None,
                 coder_axis: str = "model", lane_policy: str = "fixed", device=None):
        """lanes: any integer in [1, 65535] (the container's u16), with
        groups > 1 (the PCT1-G wire format) a multiple of groups; a stream or
        group wider than 1,024 lanes decodes on several CTAs
        (`rans_cuda.decode_span`).  coder_mesh: a
        DeviceMesh (parallel/mesh.py) whose `coder_axis` runs the G groups
        one per rank (parallel/sharded_coder.py); groups defaults to the
        axis size and must equal it.  The containers are those of
        `groups=G`.  lane_policy: "fixed" uses `lanes` for every stream;
        "auto" scales the lane count with the coded-symbol estimate from
        container metadata only, so the decoder reproduces it (rounded up
        to a multiple of groups).  The model is moved to `device` (default
        `cuda`)."""
        if coder_mesh is not None:
            from progressivecodec_tpu_torch.parallel.mesh import check_axis

            check_axis(coder_mesh, coder_axis)
            size = coder_mesh[coder_axis].size()
            groups = size if groups == 1 else groups
            if groups != size:
                raise ValueError(f"groups={groups} on a {coder_axis!r} axis of {size} ranks")
        self.coder_mesh, self.coder_axis = coder_mesh, coder_axis
        if lane_policy not in ("fixed", "auto"):
            raise ValueError(f"lane_policy {lane_policy!r}")
        if not isinstance(model, (ChannelProgressiveWACNN, SingleRateFragments)):
            raise NotImplementedError(
                "the port's codec covers ChannelProgressiveWACNN and the single-rate WACNN, STF "
                "and TCM (models/registry.py)"
            )
        device = resolve_device(device)
        set_deterministic()
        super().__init__(model.to(device).eval(), lanes, groups)
        self.lane_policy = lane_policy
        cfg = self.cfg
        self._progressive = isinstance(model, ChannelProgressiveWACNN)
        self._z_channels = model.entropy_bottleneck.channels
        self._n_base = cfg.ns0 if self._progressive else cfg.M // cfg.dim_chunk
        self._n_split = cfg.ns1 if self._progressive else cfg.M // cfg.dim_chunk
        self._scale_table = torch.as_tensor(
            cfg.scale_table.values().astype(np.float32), device=device
        )
        self.graphs = graphs.LoopGraphs()
        codec = weakref.ref(self)
        model.register_load_state_dict_post_hook(lambda module, keys: _drop_graphs(codec))

    def update(self, force: bool = False):
        """As `Codec.update`; building the tables anew (the weights changed)
        drops the graphs of the unrolled enhancement too."""
        if force or self._tables is None:
            self.graphs.clear()
        return super().update(force)

    # ---------- lane policy ----------

    def _estimate_symbols(self, batch: int, z_shape, quality: float) -> int:
        """Coded-symbol estimate from container metadata only (batch, z size,
        quality): the masked enhancement fraction is quality/10."""
        cfg = self.cfg
        hz, wz = z_shape
        hy, wy = hz * 4, wz * 4
        n_z = batch * hz * wz * self._z_channels
        n_base = batch * hy * wy * cfg.division_channel
        n_prog = 0
        if self._progressive and quality > 0:
            n_prog = int(batch * hy * wy * cfg.delta_dim * min(quality, 10.0) / 10.0)
        return n_z + n_base + n_prog

    def _lanes_for_stream(self, batch: int, z_shape, quality: float) -> int:
        if self.lane_policy != "auto":
            return self.lanes
        est = self._estimate_symbols(batch, z_shape, quality)
        lanes = 1 << max(int(est // 4096).bit_length() - 1, 0)
        lanes = max(64, min(lanes, self.lanes))
        return -(-lanes // self.groups) * self.groups

    # ---------- helpers ----------

    def _medians(self) -> torch.Tensor:
        return self.model.entropy_bottleneck.medians().detach()

    def _ones(self, n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.bool, device=self.device)

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=F32, device=self.device)

    def _stacked(self) -> bool:
        return self._progressive and self.model.stacked

    # ---------- shared pipelines ----------

    @span("glue:base_loop")
    def _base_loop(self, lm, ls, vals_fn):
        """Run the ChARM base slices; vals_fn(i, mu, idx) supplies flat integer
        values (encoder: quantized; decoder: entropy-decoded)."""
        m = self.model
        max_sup = self.cfg.max_support_slices
        y_hat_base, mu_list, std_list = [], [], []
        mu, scale, idx, ms = m.codec_base_params(0, lm, ls, (), self._scale_table)
        for i in range(self._n_base):
            mu_list.append(mu)
            std_list.append(scale)
            vals = vals_fn(i, mu, idx)
            if i + 1 < self._n_base:
                j = i + 1
                sup_needed = min(j, max_sup)
                include_prev = sup_needed > i
                support = tuple(
                    y_hat_base[: sup_needed - 1] if include_prev else y_hat_base[:sup_needed]
                )
                y_prev, mu, scale, idx, ms_next = m.codec_base_step(
                    j, include_prev, lm, ls, support, self._scale_table, ms, mu_list[i], vals
                )
                y_hat_base.append(y_prev)
                ms = ms_next
            else:
                y_hat_base.append(m.codec_base_recon(i, ms, mu_list[i], vals))
        return y_hat_base, mu_list, std_list

    @span("glue:prog_loop")
    def _prog_loop(self, quality, mask_pol, lm, ls, y_hat_base, mu_list, std_list, cust_map,
                   checkpoint_rep, vals_fn):
        """Run the unrolled enhancement slices; vals_fn(i, mu, mask, keep, idx)
        supplies flat integer values.  Returns the reconstructed enhancement
        latent (B, h, w, num_prog_slices * dim_chunk), a fresh tensor.

        The slices' quality-independent networks run as CUDA graphs where
        `self.graphs` engages (`models/graphs.py`); the request's constant
        inputs are staged into the graphs' buffers here, once per loop."""
        cfg, m = self.cfg, self.model
        n = cfg.num_prog_slices
        units = self.graphs.units(m, lm)
        lm, ls = units.stage("lm", [lm])[0], units.stage("ls", [ls])[0]
        y_hat_base = units.stage("base", y_hat_base)
        mu_b, std_b = units.stage("mu_b", mu_list[:n]), units.stage("std_b", std_list[:n])
        anchors = units.anchors(m, n, y_hat_base, checkpoint_rep)
        prog_slices, mu_total, std_total = [], [], []
        with graphs.active(units):
            for i in range(n):
                mu, scale, mut, mask, keep, idx, ms = m.codec_prog_params(
                    i, quality, mask_pol, lm, ls, tuple(y_hat_base), tuple(mu_total),
                    tuple(std_total), tuple(prog_slices), mu_b[i], std_b[i], anchors[i],
                    self._scale_table, m._map_slice(cust_map, i),
                )
                std_total.append(scale if cfg.support_std else mut)
                mu_total.append(mut)
                vals = vals_fn(i, mu, mask, keep, idx)
                prog_slices.append(m.codec_prog_recon(i, ms, mu, vals, keep, y_hat_base[i]))
        with span("glue:cat"):
            return torch.cat(prog_slices, dim=-1)

    # ---------- public API ----------

    @span("codec:compress")
    @torch.no_grad()
    def compress(self, x, quality: float = 0.0, mask_pol: str | None = None,
                 simulate: bool = False, cust_map=None, checkpoint_rep=None) -> dict:
        """x (B, H, W, 3) in [0, 1] -> container dict.  The stream and escape
        words stay on the device as int16 bit patterns; `serialize` makes
        the bytes.  `checkpoint_rep` (REM's cascade) anchors the unrolled
        enhancement's refinement hook; the decoder must pass the same."""
        self.update()
        x = self._as_input(x)
        y = self.model.analyze(x)
        return self.compress_from_latent(
            y, tuple(x.shape), quality=quality, mask_pol=mask_pol, simulate=simulate,
            cust_map=cust_map, checkpoint_rep=checkpoint_rep,
        )

    @span("codec:compress_from_latent")
    @torch.no_grad()
    def compress_from_latent(self, y, x_shape, quality: float = 0.0,
                             mask_pol: str | None = None, simulate: bool = False,
                             cust_map=None, checkpoint_rep=None) -> dict:
        """Encode from a precomputed latent y (B, h, w, M)."""
        cfg, m = self.cfg, self.model
        mask_pol = mask_pol or cfg.mask_policy
        # the container carries the quality as float32: the encoder uses that
        # value too, or a quality such as 0.58 would rank the mask's quantile
        # at another position than the decoder's
        quality = float(np.float32(quality))
        self.update()
        y = self._as_input(y)
        row0 = self.gauss_row0

        z = m.codec_hyper_enc(y)
        with span("glue:z_round"):
            med = self._medians()
            z_sym = torch.round(z - med).to(I32)
            z_idx = torch.arange(z.shape[-1], dtype=I32, device=self.device).expand(z.shape)
            z_hat = z_sym.to(F32) + med
        lm, ls = m.codec_hyper_dec(z_hat)

        dc_slice = y.shape[-1] // self._n_split
        stages = [(z_sym.reshape(-1), z_idx.reshape(-1), self._ones(z_sym.numel()))]

        @span("glue:symbols")
        def enc_vals(i, mu, idx):
            ys = y[..., i * dc_slice : i * dc_slice + mu.shape[-1]]
            sym = torch.round(ys - mu).to(I32).reshape(-1)
            stages.append((sym, (idx + row0).reshape(-1), self._ones(sym.numel())))
            return sym

        y_hat_base, mu_list, std_list = self._base_loop(lm, ls, enc_vals)

        y_hat_prog = None
        if quality > 0 and self._progressive:
            if self._stacked():
                mu_st, _, mask, keep, idx, ms, base_stack = m.codec_prog_stacked(
                    quality, mask_pol, lm, ls, tuple(y_hat_base), self._scale_table, cust_map,
                )
                with span("glue:symbols"):
                    b, h, w, _ = y.shape
                    dc = mu_st.shape[-1]
                    y5 = y.reshape(b, h, w, -1, dc)
                    prog = y5[..., cfg.ns0 : cfg.ns0 + cfg.num_prog_slices, :]
                    if cfg.delta_encode:
                        prog = prog - y5[..., : cfg.num_prog_slices, :]
                    sym = torch.round((prog.movedim(3, 0) - mu_st) * mask).to(I32)
                    stages.append((sym.reshape(-1), (idx + row0).reshape(-1), keep.reshape(-1)))
                if simulate:
                    y_hat_prog = unstack_channels(
                        m.codec_prog_recon_stacked(ms, mu_st, sym, keep, base_stack)
                    )
            else:
                base0 = cfg.ns0 * cfg.dim_chunk

                @span("glue:symbols")
                def prog_vals(i, mu, mask, keep, idx):
                    # the enhancement slice, less its unquantised base slice
                    # under delta_encode
                    lo, dc = i * dc_slice, mu.shape[-1]
                    ys = y[..., base0 + lo : base0 + lo + dc]
                    if cfg.delta_encode:
                        ys = ys - y[..., lo : lo + dc]
                    sym = torch.round((ys - mu) * mask).to(I32).reshape(-1)
                    stages.append((sym, (idx + row0).reshape(-1), keep.reshape(-1)))
                    return sym

                y_hat_prog = self._prog_loop(quality, mask_pol, lm, ls, y_hat_base, mu_list,
                                             std_list, cust_map, checkpoint_rep, prog_vals)

        hz, wz = z.shape[1], z.shape[2]
        lanes = self._lanes_for_stream(int(x_shape[0]), (hz, wz), quality)
        result = {
            "z_shape": (hz, wz),
            "batch": int(x_shape[0]),
            "quality": quality,
            "mask_pol": mask_pol,
            "lanes": lanes,
        }
        t = self.device_tables
        if self.coder_mesh is not None:
            streams, n_words, escs, n_escs = sharded_encode_stages(
                stages, t, lanes, self.coder_mesh, self.coder_axis
            )
        else:
            streams, n_words, escs, n_escs = rans_device.encode_stages(stages, t, lanes, self.groups)
        with span("sync:n_words"):
            nw, ne = torch.stack([n_words, n_escs]).tolist()
        count("words:payload", sum(nw))
        count("words:escape", 2 * sum(ne))
        with span("glue:container"):
            result.update({
                "groups": self.groups,
                "streams": [streams[g, : nw[g]] for g in range(self.groups)],
                "escs": [escs[g, : 2 * ne[g]] for g in range(self.groups)],
                "num_bytes": 2 * (sum(nw) + 2 * sum(ne)),
            })
        if simulate:
            if y_hat_prog is not None:
                result["x_hat"] = m.codec_synth(1, y_hat_prog)
                result["y_hat"] = y_hat_prog
            else:
                with span("glue:cat"):
                    y_hat_b = torch.cat(y_hat_base, dim=-1)
                result["x_hat"] = m.codec_synth(0, y_hat_b)
                result["y_hat"] = y_hat_b
        return result

    @span("codec:decompress")
    @torch.no_grad()
    def decompress(self, data: dict, cust_map=None, checkpoint_rep=None) -> dict:
        out = self.decompress_to_latent(data, cust_map=cust_map, checkpoint_rep=checkpoint_rep)
        which = 0 if float(data["quality"]) == 0 or not self._progressive else 1
        x_hat = self.model.codec_synth(which, out["y_hat"])
        return {"x_hat": x_hat, "stream_ok": out["stream_ok"], "y_hat": out["y_hat"]}

    def _words(self, x) -> torch.Tensor:
        """uint16 array or int16 tensor -> int16 tensor on the codec device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int16)
        return torch.from_numpy(np.asarray(x, dtype=np.uint16).view(np.int16).copy()).to(self.device)

    def _stage_decoder(self, data: dict, lanes: int, cap: int):
        """dec_stage(indexes, keep, row_off) -> values, over the container's
        G sub-streams (one stream: G = 1), and the decoder state it
        advances."""
        t = self.device_tables
        row0 = self.gauss_row0
        n_rows = t.offset.shape[0]
        g = self.groups
        if len(data["streams"]) != g or len(data["escs"]) != g:
            raise ValueError(f"container holds {len(data['streams'])} streams for groups={g}")
        # group g's capacity: its share of the payload and its own head
        cap_g = (cap - 2 * lanes) // g + 2 * (lanes // g)
        with span("sync:words_to_device"):
            words = [self._words(w) for w in data["streams"]]
            escs = [self._words(e) for e in data["escs"]]
        for i, (w, e) in enumerate(zip(words, escs)):
            if w.numel() > cap_g or e.numel() > 2 * cap_g:
                raise ValueError(f"group {i}'s stream is longer than its capacity")
        streams, escs = _rows(words, 0), _rows(escs, 2)
        dec = [rans_device.decoder_init(streams, lanes)]

        def dec_stage(indexes, keep, row_off):
            # z codes on the bottleneck rows [0, row0), y on the Gaussian rows
            rows = (0, row0) if row_off == 0 else (row0, n_rows)
            with span("glue:grids"):
                idx_flat = (indexes + row_off).reshape(-1).to(I32)
                kp_flat = keep.reshape(-1)
                ig = _pad_to_grid(idx_flat, lanes)
                kg = _pad_to_grid(kp_flat.to(torch.uint8), lanes)
            d = dec[0]
            if self.coder_mesh is not None:
                dec[0], vals = sharded_decode_stage(d, streams, escs, idx_flat, kp_flat, t, lanes,
                                                    self.coder_mesh, self.coder_axis, rows)
            else:
                states, offsets, cums = rans_device.decode_stage_scan(d, streams, ig, kg, t, lanes, rows)
                esc_offsets, vals = rans_device.decode_stage_values(
                    d.esc_offsets, cums, escs, idx_flat, kp_flat, t, lanes)
                dec[0] = DecoderState(states, offsets, esc_offsets)
            return vals

        return dec_stage, dec

    @span("codec:decompress_to_latent")
    @torch.no_grad()
    def decompress_to_latent(self, data: dict, cust_map=None, checkpoint_rep=None) -> dict:
        """Entropy decode + slice reconstruction, stopping before g_s."""
        cfg, m = self.cfg, self.model
        self.update()
        data_groups = int(data["groups"])
        if data_groups != self.groups:
            raise ValueError(
                f"container has groups={data_groups} but this codec was built with "
                f"groups={self.groups}"
            )
        quality = float(data["quality"])
        mask_pol = data["mask_pol"] or cfg.mask_policy
        batch = int(data["batch"])
        hz, wz = data["z_shape"]
        lanes = check_lanes(data.get("lanes", self.lanes), self.groups)
        row0 = self.gauss_row0
        dec_stage, dec = self._stage_decoder(
            data, lanes, _stream_capacity(batch, (hz, wz), self._z_channels, cfg, lanes)
        )

        n = self._z_channels
        with span("glue:grids"):
            z_idx = torch.arange(n, dtype=I32, device=self.device).expand(batch, hz, wz, n)
        z_vals = dec_stage(z_idx, self._ones(z_idx.numel()), 0)
        with span("glue:z_round"):
            z_hat = z_vals.reshape(batch, hz, wz, n).to(F32) + self._medians()
        lm, ls = m.codec_hyper_dec(z_hat)

        y_hat_base, mu_list, std_list = self._base_loop(
            lm, ls, lambda i, mu, idx: dec_stage(idx, self._ones(idx.numel()), row0)
        )
        if quality == 0 or not self._progressive:
            with span("glue:cat"):
                y_hat = torch.cat(y_hat_base, dim=-1)
        elif self._stacked():
            mu_st, _, _, keep, idx, ms, base_stack = m.codec_prog_stacked(
                quality, mask_pol, lm, ls, tuple(y_hat_base), self._scale_table, cust_map
            )
            vals = dec_stage(idx, keep, row0)
            y_hat = unstack_channels(m.codec_prog_recon_stacked(ms, mu_st, vals, keep, base_stack))
        else:
            y_hat = self._prog_loop(
                quality, mask_pol, lm, ls, y_hat_base, mu_list, std_list, cust_map, checkpoint_rep,
                lambda i, mu, mask, keep, idx: dec_stage(idx, keep, row0),
            )
        with span("sync:stream_ok"):
            ok = bool(rans_device.stream_ok(dec[0]))
        return {"y_hat": y_hat, "stream_ok": ok}


def _rows(segments, tail: int) -> torch.Tensor:
    """Word segments as the rows of a (G, W) int16 matrix, each zero-padded
    to the longest plus `tail` words, W a multiple of 8 (rows 16 bytes
    apart, as the kernel copies them); the zeros read as words past the
    end.  One segment with no tail is its own tensor, viewed as one row."""
    if len(segments) == 1 and not tail:
        return segments[0][None]
    width = -(-(max(s.numel() for s in segments) + tail) // 8) * 8
    out = segments[0].new_zeros((len(segments), width))
    for i, s in enumerate(segments):
        out[i, : s.numel()] = s
    return out


def _drop_graphs(codec_ref) -> None:
    """The model's weights were loaded anew: its codec's graphs go."""
    codec = codec_ref()
    if codec is not None:
        codec.graphs.clear()


def make_codec(model, lanes: int = DEFAULT_LANES, device=None, groups: int = 1) -> GranularCodec:
    """GranularCodec for every model family the port serves (models/registry.py)."""
    return GranularCodec(model, lanes, groups=groups, device=device)
