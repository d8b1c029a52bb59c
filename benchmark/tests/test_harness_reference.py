"""The plain reference against the port at TINY on the CPU: the same
container bytes, the same decoded latent, the same reconstruction."""

import json

import pytest
import torch

from benchmark import compare, traffic, weights
from benchmark.reference import coder
from benchmark.reference import model as ref
from benchmark.tests import tiny


def _conf(name):
    conf = json.loads((tiny.REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    conf["model"].update(tiny.TINY_MODEL)
    return conf


@pytest.mark.parametrize("name", ["flagship", "rem"])
def test_spec_names_the_ports_state_dict(name):
    from progressivecodec_tpu_torch.config import model_config_from_json
    from progressivecodec_tpu_torch.models.registry import get_model

    conf = _conf(name)
    model = get_model(model_config_from_json(json.dumps(conf["model"])), device="meta")
    spec = {n: tuple(s) for n, s, _ in ref.param_spec(ref.Cfg(conf["model"]))}
    assert spec == {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["flagship", "rem"])
def test_reference_matches_the_port(name):
    from progressivecodec_tpu_torch.config import model_config_from_json
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.models.registry import get_model

    conf = _conf(name)
    cfg = ref.Cfg(conf["model"])
    P = weights.draw_weights(ref.param_spec(cfg), 2**32 + 3, "cpu", conf["init"])
    model = get_model(model_config_from_json(json.dumps(conf["model"])), device="cpu")
    model.load_state_dict(P, strict=True)
    codec = GranularCodec(model, lanes=64, device="cpu")
    eb = {k.split(".")[-1]: v.numpy() for k, v in P.items() if "entropy_bottleneck" in k}
    tables = coder.Tables(eb, cfg.scale_table)
    x = traffic.image_pool({"height": 64, "width": 64, "pool": 2, "pool_seed": 4}, "cpu")
    for q in (0.0, 0.2, 3.7, 10.0):
        blob = codec.serialize(codec.compress(x, quality=q))
        out = codec.decompress(codec.deserialize(blob))
        r = ref.reference_request(P, cfg, x, q)
        nums = compare.compare(r, blob, out["x_hat"], out["y_hat"], tables, 64, 2, q,
                               "point-based-std")
        assert nums["bytes_gap"] == 0 and nums["z_mismatch"] == 0, (q, nums)
        assert nums["yhat_mismatch"] == 0 and nums["xhat_rel_l2"] == 0, (q, nums)
        assert len(blob) == nums["ref_bytes"]
