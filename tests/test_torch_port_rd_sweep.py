"""PyTorch port: the RD sweep CLI (`cli.rd_sweep`), against the JAX package's.

At TINY (N=32, M=64, dim_chunk 8, 32 scale levels; `ModelConfig` patched
as tests/test_cli.py patches it) with seeded weights, on the CPU.
`--synthetic` is patched to a 192x192 image: at the CLI's 512x512 the
plain rANS twins make a CPU sweep about seven times longer, and 192 is the
smallest multiple of 64 on which MS-SSIM's five scales fit.

  * the coarse grid is JAX's 12 qualities and the full grid JAX's
    `QUALITY_GRID`, 61 qualities (0.0-5.0 by 0.1, then 5.5-10.0 by 0.5);
  * `--synthetic --max-images 1 --grid coarse --device cpu` writes JAX's
    keys; bpp is finite and non-decreasing in the quality (the masks are
    nested); BD-rate is a float or JAX's "n/a (...)" string;
  * `--checkpoint` of a checkpoint of the port's trainer, holding the same
    weights, gives the same numbers;
  * without `--device` the CLI asks for the card and raises without one.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from progressivecodec_tpu.utils.rd import QUALITY_GRID as JAX_QUALITY_GRID

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.cli import rd_sweep
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig, TrainConfig
from progressivecodec_tpu_torch.data.datasets import SyntheticDataset
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.training.checkpoint import save_checkpoint
from progressivecodec_tpu_torch.training.step import init_train_state

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = ModelConfig(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64),
                  scale_table=ScaleTableConfig(levels=32))
KEYS = {"qualities", "bpp", "psnr", "ms_ssim_db", "bd_rate_vs_fixed_pret"}
ARGS = ["--synthetic", "--max-images", "1", "--grid", "coarse", "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny_cli():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rd_sweep, "ModelConfig", lambda: CFG)
        mp.setattr(rd_sweep, "SyntheticDataset", lambda n, size: SyntheticDataset(n=n, size=192))
        yield


@pytest.fixture(scope="module")
def default_run(tiny_cli, tmp_path_factory):
    out = tmp_path_factory.mktemp("rd") / "rd.json"
    return rd_sweep.main(ARGS + ["--out", str(out)]), out


def jax_coarse_grid() -> list:
    """The list literal JAX's rd_sweep assigns to `grid` for --grid coarse."""
    tree = ast.parse((REPO / "progressivecodec_tpu" / "cli" / "rd_sweep.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "grid":
            return ast.literal_eval(node.value.orelse)
    raise AssertionError("no grid assignment in JAX's rd_sweep")


def test_grids_match_jax():
    assert list(rd_sweep.COARSE_GRID) == jax_coarse_grid() and len(rd_sweep.COARSE_GRID) == 12
    assert rd_sweep.QUALITY_GRID == JAX_QUALITY_GRID and len(rd_sweep.QUALITY_GRID) == 61
    assert rd_sweep.QUALITY_GRID[:51] == tuple(round(0.1 * i, 1) for i in range(51))
    assert rd_sweep.QUALITY_GRID[51:] == tuple(5.5 + 0.5 * i for i in range(10))


def test_rd_sweep_writes_json(default_run):
    result, out = default_run
    assert set(result) == KEYS
    assert json.loads(out.read_text()) == result
    assert result["qualities"] == list(rd_sweep.COARSE_GRID)
    for k in ("bpp", "psnr", "ms_ssim_db"):
        assert len(result[k]) == 12 and np.isfinite(result[k]).all(), k
    assert all(a <= b for a, b in zip(result["bpp"], result["bpp"][1:])), result["bpp"]
    bd = result["bd_rate_vs_fixed_pret"]
    assert isinstance(bd, float) or bd.startswith("n/a ("), bd


def test_rd_sweep_from_a_trainer_checkpoint(default_run, tmp_path):
    model = get_model(CFG, device="cpu")
    model.load_state_dict(init_params(CFG, torch.Generator().manual_seed(0)), strict=True)
    ckpt = tmp_path / "ckpt_last"
    save_checkpoint(str(ckpt), init_train_state(model, TrainConfig()), CFG, TrainConfig())
    result = rd_sweep.main(ARGS + ["--checkpoint", str(ckpt), "--out", str(tmp_path / "rd.json")])
    assert result == default_run[0]


def test_rd_sweep_needs_the_card_unless_asked(tiny_cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rd_sweep.main(["--synthetic", "--out", str(tmp_path / "rd.json")])
