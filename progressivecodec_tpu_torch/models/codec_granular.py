"""Granular codec: compress / decompress through shared model fragments.

Counterpart of `progressivecodec_tpu/models/codec_granular.py` for the
stacked ChannelProgressiveWACNN with one stream (groups=1).

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
`decompress` (z, each base slice, and the stacked enhancement stage when
quality > 0).
"""

from __future__ import annotations

import numpy as np
import torch

from progressivecodec_tpu_torch.coder import rans_device
from progressivecodec_tpu_torch.coder.rans_device import DecoderState, _pad_to_grid
from progressivecodec_tpu_torch.coder.tables import DEFAULT_LANES, check_lanes
from progressivecodec_tpu_torch.device import resolve_device, set_deterministic
from progressivecodec_tpu_torch.models.codec import Codec, _stream_capacity
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN

F32 = torch.float32
I32 = torch.int32


class GranularCodec(Codec):
    """Codec with per-stage shared fragments for the stacked progressive model."""

    def __init__(self, model: ChannelProgressiveWACNN, lanes: int = DEFAULT_LANES,
                 groups: int = 1, coder_mesh=None, lane_policy: str = "fixed",
                 device=None):
        """lanes: a multiple of 32 in [32, 1024] (one decode CTA of whole
        warps).  lane_policy: "fixed" uses `lanes` for every stream; "auto"
        scales the lane count with the coded-symbol estimate from container
        metadata only, so the decoder reproduces it.  The model is moved to
        `device` (default `cuda`)."""
        if groups != 1 or coder_mesh is not None:
            raise NotImplementedError(
                "PCT1-G grouped and mesh-sharded coding come with a later slice of the port"
            )
        if lane_policy not in ("fixed", "auto"):
            raise ValueError(f"lane_policy {lane_policy!r}")
        if not isinstance(model, ChannelProgressiveWACNN):
            raise NotImplementedError("the port's codec covers ChannelProgressiveWACNN only")
        device = resolve_device(device)
        set_deterministic()
        super().__init__(model.to(device).eval(), lanes)
        self.lane_policy = lane_policy
        cfg = self.cfg
        self._n_base = cfg.ns0
        self._n_split = cfg.ns1
        self._scale_table = torch.as_tensor(
            cfg.scale_table.values().astype(np.float32), device=device
        )

    # ---------- lane policy ----------

    def _estimate_symbols(self, batch: int, z_shape, quality: float) -> int:
        """Coded-symbol estimate from container metadata only (batch, z size,
        quality): the masked enhancement fraction is quality/10."""
        cfg = self.cfg
        hz, wz = z_shape
        hy, wy = hz * 4, wz * 4
        n_z = batch * hz * wz * cfg.N
        n_base = batch * hy * wy * cfg.division_channel
        n_prog = int(batch * hy * wy * cfg.delta_dim * min(quality, 10.0) / 10.0) if quality > 0 else 0
        return n_z + n_base + n_prog

    def _lanes_for_stream(self, batch: int, z_shape, quality: float) -> int:
        if self.lane_policy != "auto":
            return self.lanes
        est = self._estimate_symbols(batch, z_shape, quality)
        lanes = 1 << max(int(est // 4096).bit_length() - 1, 0)
        return max(64, min(lanes, self.lanes))

    # ---------- helpers ----------

    def _medians(self) -> torch.Tensor:
        return self.model.entropy_bottleneck.medians().detach()

    @staticmethod
    def _unstack(x_stack):
        """(S, B, h, w, dc) -> (B, h, w, S*dc), slice-major channels."""
        s_, b, h, w, dc = x_stack.shape
        return x_stack.permute(1, 2, 3, 0, 4).reshape(b, h, w, s_ * dc)

    def _ones(self, n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.bool, device=self.device)

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=F32, device=self.device)

    # ---------- shared base pipeline ----------

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

    # ---------- public API ----------

    @torch.no_grad()
    def compress(self, x, quality: float = 0.0, mask_pol: str | None = None,
                 simulate: bool = False, cust_map=None) -> dict:
        """x (B, H, W, 3) in [0, 1] -> container dict.  The stream and escape
        words stay on the device as int16 bit patterns; `serialize` makes
        the bytes."""
        self.update()
        x = self._as_input(x)
        y = self.model.analyze(x)
        return self.compress_from_latent(
            y, tuple(x.shape), quality=quality, mask_pol=mask_pol, simulate=simulate,
            cust_map=cust_map,
        )

    @torch.no_grad()
    def compress_from_latent(self, y, x_shape, quality: float = 0.0,
                             mask_pol: str | None = None, simulate: bool = False,
                             cust_map=None) -> dict:
        """Encode from a precomputed latent y (B, h, w, M)."""
        cfg, m = self.cfg, self.model
        mask_pol = mask_pol or cfg.mask_policy
        self.update()
        y = self._as_input(y)
        row0 = self.gauss_row0

        z = m.codec_hyper_enc(y)
        med = self._medians()
        z_sym = torch.round(z - med).to(I32)
        z_idx = torch.arange(z.shape[-1], dtype=I32, device=self.device).expand(z.shape)
        z_hat = z_sym.to(F32) + med
        lm, ls = m.codec_hyper_dec(z_hat)

        dc_slice = y.shape[-1] // self._n_split
        stages = [(z_sym.reshape(-1), z_idx.reshape(-1), self._ones(z_sym.numel()))]

        def enc_vals(i, mu, idx):
            ys = y[..., i * dc_slice : i * dc_slice + mu.shape[-1]]
            sym = torch.round(ys - mu).to(I32).reshape(-1)
            stages.append((sym, (idx + row0).reshape(-1), self._ones(sym.numel())))
            return sym

        y_hat_base, _, _ = self._base_loop(lm, ls, enc_vals)

        y_hat_prog = None
        if quality > 0:
            mu_st, _, mask, keep, idx, ms, base_stack = m.codec_prog_stacked(
                float(quality), mask_pol, lm, ls, tuple(y_hat_base), self._scale_table,
                cust_map,
            )
            b, h, w, _ = y.shape
            dc = mu_st.shape[-1]
            y5 = y.reshape(b, h, w, -1, dc)
            prog = y5[..., cfg.ns0 : cfg.ns0 + cfg.num_prog_slices, :]
            if cfg.delta_encode:
                prog = prog - y5[..., : cfg.num_prog_slices, :]
            y_prog = prog.movedim(3, 0)
            sym = torch.round((y_prog - mu_st) * mask).to(I32)
            stages.append((sym.reshape(-1), (idx + row0).reshape(-1), keep.reshape(-1)))
            if simulate:
                y_hat_prog = self._unstack(
                    m.codec_prog_recon_stacked(ms, mu_st, sym, keep, base_stack)
                )

        hz, wz = z.shape[1], z.shape[2]
        lanes = self._lanes_for_stream(int(x_shape[0]), (hz, wz), float(quality))
        stream, n_words, esc, n_esc = rans_device.encode_stages(
            stages, self.device_tables, lanes
        )
        n_words, n_esc = int(n_words), int(n_esc)
        result = {
            "stream": stream[:n_words],
            "esc": esc[: 2 * n_esc],
            "num_bytes": 2 * (n_words + 2 * n_esc),
            "z_shape": (hz, wz),
            "batch": int(x_shape[0]),
            "quality": float(quality),
            "mask_pol": mask_pol,
            "lanes": lanes,
        }
        if simulate:
            if quality > 0:
                result["x_hat"] = m.codec_synth(1, y_hat_prog)
                result["y_hat"] = y_hat_prog
            else:
                y_hat_b = torch.cat(y_hat_base, dim=-1)
                result["x_hat"] = m.codec_synth(0, y_hat_b)
                result["y_hat"] = y_hat_b
        return result

    @torch.no_grad()
    def decompress(self, data: dict, cust_map=None) -> dict:
        out = self.decompress_to_latent(data, cust_map=cust_map)
        which = 0 if float(data["quality"]) == 0 else 1
        x_hat = self.model.codec_synth(which, out["y_hat"])
        return {"x_hat": x_hat, "stream_ok": out["stream_ok"], "y_hat": out["y_hat"]}

    def _words(self, x) -> torch.Tensor:
        """uint16 array or int16 tensor -> int16 tensor on the codec device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int16)
        return torch.from_numpy(np.asarray(x, dtype=np.uint16).view(np.int16).copy()).to(self.device)

    @torch.no_grad()
    def decompress_to_latent(self, data: dict, cust_map=None) -> dict:
        """Entropy decode + slice reconstruction, stopping before g_s."""
        cfg, m = self.cfg, self.model
        self.update()
        if int(data.get("groups", 1)) != 1:
            raise ValueError(f"container has groups={data['groups']}; the port decodes groups=1")
        quality = float(data["quality"])
        mask_pol = data["mask_pol"] or cfg.mask_policy
        batch = int(data["batch"])
        hz, wz = data["z_shape"]
        lanes = check_lanes(data.get("lanes", self.lanes))
        t = self.device_tables
        row0 = self.gauss_row0

        stream = self._words(data["stream"])
        if stream.numel() > _stream_capacity(batch, (hz, wz), cfg, lanes):
            raise ValueError("stream longer than the container's capacity")
        esc = torch.cat([self._words(data.get("esc", np.zeros(0, np.uint16))),
                         torch.zeros(2, dtype=torch.int16, device=self.device)])
        dec = [rans_device.decoder_init(stream, lanes)]

        n_rows = t.offset.shape[0]

        def dec_stage(indexes, keep, row_off):
            # z codes on the bottleneck rows [0, row0), y on the Gaussian rows
            rows = (0, row0) if row_off == 0 else (row0, n_rows)
            idx_flat = (indexes + row_off).reshape(-1).to(I32)
            kp_flat = keep.reshape(-1)
            states, offset, cums = rans_device.decode_stage_scan(
                dec[0], stream, _pad_to_grid(idx_flat, lanes),
                _pad_to_grid(kp_flat.to(torch.uint8), lanes), t, lanes, rows,
            )
            esc_offset, vals = rans_device.decode_stage_values(
                dec[0].esc_offset, cums, esc, idx_flat, kp_flat, t, lanes
            )
            dec[0] = DecoderState(states, offset, esc_offset)
            return vals

        n = cfg.N
        z_idx = torch.arange(n, dtype=I32, device=self.device).expand(batch, hz, wz, n)
        z_vals = dec_stage(z_idx, self._ones(z_idx.numel()), 0)
        z_hat = z_vals.reshape(batch, hz, wz, n).to(F32) + self._medians()
        lm, ls = m.codec_hyper_dec(z_hat)

        y_hat_base, _, _ = self._base_loop(
            lm, ls, lambda i, mu, idx: dec_stage(idx, self._ones(idx.numel()), row0)
        )
        if quality == 0:
            y_hat = torch.cat(y_hat_base, dim=-1)
        else:
            mu_st, _, _, keep, idx, ms, base_stack = m.codec_prog_stacked(
                quality, mask_pol, lm, ls, tuple(y_hat_base), self._scale_table, cust_map
            )
            vals = dec_stage(idx, keep, row0)
            y_hat = self._unstack(m.codec_prog_recon_stacked(ms, mu_st, vals, keep, base_stack))
        return {"y_hat": y_hat, "stream_ok": bool(rans_device.stream_ok(dec[0]))}


def make_codec(model: ChannelProgressiveWACNN, lanes: int = DEFAULT_LANES,
               device=None) -> GranularCodec:
    """GranularCodec for the port's model family."""
    return GranularCodec(model, lanes, device=device)
