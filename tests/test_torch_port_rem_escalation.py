"""PyTorch port: REM's escalation cascade against JAX's.

At TINY with live banks (tests/test_torch_port_rem.py, `live_rem_weights`),
the port's cascade at q=10 (its round trips against itself are in
test_torch_port_rem_codec.py) matches JAX `escalation_compress` on the same weights: the same
    number of levels, each level's quality (as the container's float32
    holds it) and each level's bytes within 1%, with the default levels
    and with a first level float32 cannot hold (0.1), where no bank runs,
    as in JAX.  Past the 5-byte header (magic and format version, which
    differ by design) every level's container is byte-identical to JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.models import rem as jax_rem
from progressivecodec_tpu.models.codec_granular import GranularCodec as JaxGranularCodec
from progressivecodec_tpu.models.rem import PostRateProcessedNetwork as JaxREM
from test_torch_port_rem import CFG, JCFG, build_rem
from test_torch_port_variants import image, share_jax_compiles
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.models import rem
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model


HEADER = 5  # magic and format version: the port's container is b"PTC2" v1


@pytest.fixture(scope="module")
def setup():
    return build_rem()


def through_container(codec, data):
    return codec.deserialize(codec.serialize(data))


def _count_bank_calls(model):
    """A list that grows by one on every LatentRateReduction call."""
    calls = []
    for level in model.post_latent:
        for bank in level:
            bank.register_forward_hook(lambda *_: calls.append(1))
    return calls


@pytest.mark.parametrize("levels", [(0.01, 0.25, 1.75), (0.1, 0.25, 1.75)])
def test_escalation_matches_jax(setup, levels):
    """Level count, qualities, bytes and payloads per level against JAX's
    cascade (a stale or wrong anchor changes the refined sigma and so the
    payload); a first level of 0.1 (float32 holds 0.10000000149) codes without a bank
    on both sides, and the port still decodes it."""
    _, params = setup
    share_jax_compiles()
    cfg = dataclasses.replace(CFG, check_levels=levels)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(setup[0].state_dict(), strict=True)
    calls = _count_bank_calls(model)
    codec = make_codec(model, lanes=64, device="cpu")
    jcodec = JaxGranularCodec(JaxREM(cfg=dataclasses.replace(JCFG, check_levels=levels)),
                              {"params": params}, lanes=64)
    x = image(37)
    theirs = jax_rem.escalation_compress(jcodec, jnp.asarray(x), quality=10.0)
    ours = rem.escalation_compress(codec, torch.from_numpy(x), quality=10.0)
    assert len(ours["checkpoints"]) == len(theirs["checkpoints"]) == len(levels)
    for a, b in zip(ours["checkpoints"] + [ours["final"]],
                    theirs["checkpoints"] + [theirs["final"]]):
        assert a["quality"] == float(np.float32(b["quality"]))
        assert abs(a["num_bytes"] - b["num_bytes"]) <= 0.01 * b["num_bytes"]
        assert codec.serialize(a)[HEADER:] == jcodec.serialize(b)[HEADER:]
    # the first level runs no bank; every later one runs one per slice
    assert len(calls) == len(levels) * CFG.num_prog_slices
    sent = {"checkpoints": [through_container(codec, d) for d in ours["checkpoints"]],
            "final": through_container(codec, ours["final"])}
    out = rem.escalation_decompress(codec, sent)
    assert out["stream_ok"] and torch.equal(out["y_hat"], ours["final"]["y_hat"])
    assert len(calls) == 2 * len(levels) * CFG.num_prog_slices
