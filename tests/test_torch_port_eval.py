"""PyTorch port vs the JAX package: the eval path.

  * `psnr`, `ms_ssim` and `ms_ssim_db` on NHWC images agree with JAX's
    within 1e-4;
  * `SyntheticDataset`, `SyntheticKodak` and `natural_image` (JAX's
    `NaturalSyntheticDataset.generate`) give JAX's arrays exactly (both are
    numpy); `ImageFolderDataset` and `KodakDataset` read PNGs as JAX's do,
    from the same folders, and an empty Kodak folder raises;
  * `evaluate_codec` on one 256x256 image at q in {0, 10} with the TINY
    flagship layout and the same weights: bpp within 1% of JAX's, PSNR and
    MS-SSIM within 0.01 dB (`entropy_estimate_eval` is held to JAX's in
    tests/test_torch_port_forward.py);
  * `cli.eval.main([... "--device", "cpu", "--synthetic"])` writes its
    JSON, with the real bpp inside JAX's own bound of the estimate (real <
    est * 1.25 + 0.3, tests/test_cli.py); --checkpoint on a checkpoint of
    the port's trainer is in tests/test_torch_port_train_cli.py, and on one
    of the JAX package it is refused in tests/test_torch_port_codec.py.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.data import datasets as jax_datasets
from progressivecodec_tpu.models.codec_granular import GranularCodec as JaxGranularCodec
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import import_progressive
from progressivecodec_tpu.training import evaluate as jax_evaluate
from progressivecodec_tpu.utils import metrics as jax_metrics
from test_torch_port_variants import share_jax_compiles
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

import progressivecodec_tpu_torch.cli.eval as eval_cli
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.data import datasets
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.training import evaluate
from progressivecodec_tpu_torch.utils import metrics

TINY_KW = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))
QUALITIES = (0.0, 10.0)


@pytest.mark.parametrize("noise", [0.01, 0.2])
@pytest.mark.parametrize("shape", [(1, 192, 192, 3), (2, 200, 230, 3)])
def test_metrics_match_jax(shape, noise):
    """PSNR and MS-SSIM within 1e-4.  Both MS-SSIMs are float32 and each is
    ~1e-6 off a float64 evaluation, which the dB form scales by
    10 / ln(10) / (1 - MS-SSIM); its bound is that of 2e-6."""
    rng = np.random.default_rng(int(noise * 100) + shape[0])
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    theirs = {fn: float(getattr(jax_metrics, fn)(ja, jb)) for fn in ("psnr", "ms_ssim", "ms_ssim_db")}
    bounds = {"psnr": 1e-4, "ms_ssim": 1e-4,
              "ms_ssim_db": 10 / np.log(10) * 2e-6 / (1 - theirs["ms_ssim"])}
    for fn, bound in bounds.items():
        ours = float(getattr(metrics, fn)(ta, tb))
        assert abs(ours - theirs[fn]) <= bound, (fn, ours, theirs[fn])
    assert float(metrics.ms_ssim(ta, ta)) > 0.9999


def test_synthetic_datasets_match_jax():
    pairs = [
        (datasets.SyntheticDataset(n=3, size=64, seed=5),
         jax_datasets.SyntheticDataset(n=3, size=64, seed=5)),
        (datasets.SyntheticKodak(n=1), jax_datasets.SyntheticKodak(n=1)),
    ]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs)
        for i in range(len(ours)):
            a = ours[i]
            np.testing.assert_array_equal(a, theirs[i])
            assert a.dtype == np.float32
    assert pairs[1][0][0].shape == (512, 768, 3)
    for seed, (h, w) in [(1, (96, 96)), (2, (64, 80))]:
        ours = datasets.natural_image(np.random.default_rng(seed), h, w)
        theirs = jax_datasets.NaturalSyntheticDataset.generate(np.random.default_rng(seed), h, w)
        np.testing.assert_array_equal(ours, theirs)
        assert ours.dtype == np.float32 and ours.shape == (h, w, 3)


def test_image_folders_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(6)
    for name in ("b.png", "a.png", "notes.txt"):
        if name.endswith(".png"):
            Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(tmp_path / name)
        else:
            (tmp_path / name).write_text("not an image")
    ours, theirs = datasets.KodakDataset(str(tmp_path)), jax_datasets.KodakDataset(str(tmp_path))
    assert [f.rsplit("/", 1)[1] for f in ours.files] == ["a.png", "b.png"]
    assert ours.files == theirs.files
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i], theirs[i])
    # root/split/data, then root/split, then root
    (tmp_path / "val" / "data").mkdir(parents=True)
    (tmp_path / "val" / "data" / "c.png").write_bytes((tmp_path / "a.png").read_bytes())
    for split in ("val", "missing"):
        folder = datasets.ImageFolderDataset(str(tmp_path), split=split)
        assert folder.files == jax_datasets.ImageFolderDataset(str(tmp_path), split=split).files
    assert [f.rsplit("/", 1)[1] for f in folder.files] == ["a.png", "b.png"]
    assert datasets.ImageFolderDataset(str(tmp_path), split="val").files[0].endswith("c.png")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        datasets.KodakDataset(str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def setup():
    sd = init_params(CFG, torch.Generator().manual_seed(40))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = get_model(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    images = [datasets.SyntheticDataset(n=1, size=256, seed=41)[0]]
    return make_codec(model, lanes=64, device="cpu"), params, images


def _close(ours: dict, theirs: dict, keys) -> None:
    for k in keys:
        for q, a, b in zip(QUALITIES, ours[k], theirs[k]):
            if k == "bpp":
                assert abs(a - b) <= 0.01 * b, (k, q, a, b)
            else:
                assert abs(a - b) <= 0.01, (k, q, a, b)


def test_evaluate_codec_matches_jax(setup):
    codec, params, images = setup
    share_jax_compiles()
    jcodec = JaxGranularCodec(JaxModel(cfg=JCFG), {"params": params}, lanes=64)
    ours = evaluate.evaluate_codec(codec, images, pr_list=QUALITIES)
    theirs = jax_evaluate.evaluate_codec(jcodec, images, pr_list=QUALITIES)
    assert ours["n_images"] == theirs["n_images"] == 1
    _close(ours, theirs, ("bpp", "psnr", "ms_ssim_db"))
    assert ours["bpp"][0] < ours["bpp"][1]
    assert all(t > 0 for t in ours["enc_time"] + ours["dec_time"])


def test_eval_cli_writes_json(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(eval_cli, "ModelConfig", lambda: CFG)
    out = tmp_path / "res.json"
    eval_cli.main(["--synthetic", "--max-images", "1", "--qualities", "0,10", "--device", "cpu",
                   "--out", str(out)])
    result = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == result
    assert result["qualities"] == [0.0, 10.0] and result["device"] == "cpu"
    real, est = result["real_codec"], result["entropy_estimate"]
    assert real["n_images"] == est["n_images"] == 1
    assert real["bpp"][0] < real["bpp"][1]
    for e, r in zip(est["bpp"], real["bpp"]):
        assert r < e * 1.25 + 0.3
