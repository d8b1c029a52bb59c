"""PyTorch port: the PCT1-G coder sharded over the ranks of a mesh axis.

One 2-rank gloo job on the CPU (tests/torch_port_ranks.py) runs every case
of this file; JAX's references are computed here, on the conftest's
virtual CPU devices.  With the payloads of tests/test_sharded_coder.py
(escapes, keep < 1), at K in {64, 32} with G = 2 (kt = 32, and kt = 16,
which the encode kernel takes padded to a warp):
  * the sharded encoder's per-group streams and escape segments equal
    JAX's `sharded_encode_stages` on a 2-device mesh and the port's
    single-process `encode_stages(..., groups=2)`, byte for byte, on both ranks;
  * the sharded decode gives the symbols exactly, with stream_ok;
  * `GranularCodec(coder_mesh=...)` writes the containers of
    `GranularCodec(groups=2)`, and each decodes the other's, bit-exact;
  * a mesh without the axis, a group count other than the axis size, and
    lanes that the axis does not divide are refused.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_port_ranks
from progressivecodec_tpu_torch.coder import rans_device
from progressivecodec_tpu_torch.coder.tables import merge_tables
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables

LANES = (64, 32)
QUALITIES = (0, 5)
CFG = ModelConfig(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64),
                  scale_table=ScaleTableConfig(levels=32))


def _tables():
    merged, _ = merge_tables(build_gaussian_tables(ScaleTableConfig().values()))
    return merged


def _payload(rng, tables, n, keep_p=1.0, escapes=False):
    """tests/test_sharded_coder.py's `_payload`, here so that a rank loads no
    JAX (`jax_streams` checks that the two draw the same)."""
    idx = rng.integers(0, tables.cdf.shape[0], n).astype(np.int32)
    sym = np.round(rng.standard_normal(n) * 4).astype(np.int32)
    if escapes:
        hot = rng.random(n) < 0.01
        sym = np.where(hot, (rng.standard_normal(n) * 1e6).astype(np.int32), sym)
    keep = rng.random(n) < keep_p
    return sym, idx, keep


def _stages(lanes, payload=_payload):
    """Three stages of those payloads, escapes and keep < 1 included."""
    rng = np.random.default_rng(100 + lanes)
    t = _tables()
    return [payload(rng, t, 800, 0.9, escapes=True), payload(rng, t, 100, 1.0),
            payload(rng, t, 333, 0.5, escapes=True)]


def _image():
    return np.random.default_rng(5).random((1, 64, 64, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the ranks' job
# ---------------------------------------------------------------------------


def rank_job(rank, world, workdir):
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.models.registry import get_model
    from progressivecodec_tpu_torch.models.weights import init_params
    from progressivecodec_tpu_torch.parallel.mesh import make_mesh
    from progressivecodec_tpu_torch.parallel.sharded_coder import (
        sharded_decode_stage,
        sharded_encode_stages,
    )

    mesh = make_mesh(1, 2, device_type="cpu")
    t = rans_device.DeviceTables.from_tables(_tables(), "cpu")
    out = {"coder": {}, "codec": {}, "refused": []}
    for lanes in LANES:
        stages = [tuple(torch.from_numpy(a) for a in s) for s in _stages(lanes)]
        streams, n_words, escs, n_escs = sharded_encode_stages(stages, t, lanes, mesh)
        padded = torch.nn.functional.pad(escs, (0, 2))
        dec = rans_device.decoder_init(streams, lanes)
        values = []
        for sym, idx, keep in stages:
            dec, vals = sharded_decode_stage(dec, streams, padded, idx, keep, t, lanes, mesh)
            values.append(vals.numpy())
        out["coder"][lanes] = dict(
            streams=streams.numpy().view(np.uint16), n_words=n_words.numpy(),
            escs=escs.numpy().view(np.uint16),
            n_escs=n_escs.numpy(), values=values, stream_ok=bool(rans_device.stream_ok(dec)),
            offsets=dec.offsets.numpy(),
        )

    model = get_model(CFG, device="cpu")
    model.load_state_dict(init_params(CFG, torch.Generator().manual_seed(0)), strict=True)
    sharded = GranularCodec(model, lanes=64, coder_mesh=mesh, device="cpu")
    fused = GranularCodec(model, lanes=64, groups=2, device="cpu")
    x = torch.from_numpy(_image())
    for q in QUALITIES:
        d_s = sharded.compress(x, quality=q, simulate=True)
        d_f = fused.compress(x, quality=q, simulate=True)
        cross_f = fused.decompress(sharded.deserialize(sharded.serialize(d_s)))
        cross_s = sharded.decompress(fused.deserialize(fused.serialize(d_f)))
        out["codec"][q] = dict(
            groups=sharded.groups, blob_s=sharded.serialize(d_s), blob_f=fused.serialize(d_f),
            y_hat_s=d_s["y_hat"].numpy(), y_hat_f=d_f["y_hat"].numpy(),
            cross_f=(cross_f["stream_ok"], cross_f["y_hat"].numpy()),
            cross_s=(cross_s["stream_ok"], cross_s["y_hat"].numpy()),
        )

    def refused(what, fn):
        try:
            fn()
        except ValueError as e:
            out["refused"].append((what, str(e)))

    refused("axis", lambda: GranularCodec(model, lanes=64, coder_mesh=mesh, coder_axis="tile",
                                          device="cpu"))
    refused("groups", lambda: GranularCodec(model, lanes=64, groups=4, coder_mesh=mesh,
                                            device="cpu"))
    stages = [tuple(torch.from_numpy(a) for a in s) for s in _stages(64)]
    refused("lanes", lambda: sharded_encode_stages(stages, t, 63, mesh))
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_port_ranks.run_ranks("test_torch_port_sharded_coder",
                                      tmp_path_factory.mktemp("sharded_coder"), timeout=240)


@pytest.fixture(scope="module")
def jax_streams():
    """JAX's `sharded_encode_stages` on a (1, 2) mesh of virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from progressivecodec_tpu.coder import rans_device as jax_rans_device
    from progressivecodec_tpu.coder.tables import merge_tables as jax_merge_tables
    from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
    from progressivecodec_tpu.entropy import build_gaussian_tables as jax_gaussian_tables
    from progressivecodec_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from progressivecodec_tpu.parallel.sharded_coder import sharded_encode_stages as jax_encode

    from test_sharded_coder import _payload as jax_payload

    merged, _ = jax_merge_tables(jax_gaussian_tables(JaxScaleTableConfig().values()))
    np.testing.assert_array_equal(merged.cdf, _tables().cdf)
    for ours, theirs in zip(_stages(64), _stages(64, jax_payload)):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    dtables = jax_rans_device.DeviceTables.from_tables(merged)
    mesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    out = {}
    for lanes in LANES:
        jst = [tuple(jnp.asarray(a) for a in s) for s in _stages(lanes)]
        with mesh:
            out[lanes] = [np.asarray(a) for a in jax_encode(jst, dtables, lanes, mesh, "model")]
    return out


@pytest.mark.timeout(400)
@pytest.mark.parametrize("lanes", LANES)
def test_sharded_encode_matches_jax(ranks, jax_streams, lanes):
    for r in ranks:
        got = r["coder"][lanes]
        for key, want in zip(("streams", "n_words", "escs", "n_escs"), jax_streams[lanes]):
            np.testing.assert_array_equal(got[key], want, err_msg=f"{key} lanes={lanes}")


@pytest.mark.timeout(400)
@pytest.mark.parametrize("lanes", LANES)
def test_sharded_encode_matches_single_process_grouped(ranks, lanes):
    t = rans_device.DeviceTables.from_tables(_tables(), "cpu")
    stages = [tuple(torch.from_numpy(a) for a in s) for s in _stages(lanes)]
    want = rans_device.encode_stages(stages, t, lanes, 2)
    for r in ranks:
        got = r["coder"][lanes]
        for key, w in zip(("streams", "n_words", "escs", "n_escs"), want):
            w = w.numpy().view(np.uint16) if w.dtype == torch.int16 else w.numpy()
            np.testing.assert_array_equal(got[key], w, err_msg=f"{key} lanes={lanes}")


@pytest.mark.timeout(400)
@pytest.mark.parametrize("lanes", LANES)
def test_sharded_decode_exact_with_stream_ok(ranks, lanes):
    stages = _stages(lanes)
    for r in ranks:
        got = r["coder"][lanes]
        assert got["stream_ok"], f"lanes={lanes}"
        np.testing.assert_array_equal(got["offsets"], got["n_words"].astype(np.int32))
        for (sym, _, keep), vals in zip(stages, got["values"]):
            np.testing.assert_array_equal(vals, np.where(keep, sym, 0))


@pytest.mark.timeout(400)
@pytest.mark.parametrize("q", QUALITIES)
def test_coder_mesh_codec_writes_the_grouped_container(ranks, q):
    for r in ranks:
        got = r["codec"][q]
        assert got["groups"] == 2
        assert got["blob_s"] == got["blob_f"], f"q={q}"
        np.testing.assert_array_equal(got["y_hat_s"], got["y_hat_f"])
    assert ranks[0]["codec"][q]["blob_s"] == ranks[1]["codec"][q]["blob_s"]


@pytest.mark.timeout(400)
@pytest.mark.parametrize("q", QUALITIES)
def test_coder_mesh_codec_cross_decodes(ranks, q):
    for r in ranks:
        got = r["codec"][q]
        for ok, y_hat in (got["cross_f"], got["cross_s"]):
            assert ok, f"q={q}"
            np.testing.assert_array_equal(y_hat, got["y_hat_f"])


@pytest.mark.timeout(400)
def test_coder_mesh_refusals(ranks):
    for r in ranks:
        assert [w for w, _ in r["refused"]] == ["axis", "groups", "lanes"], r["refused"]
