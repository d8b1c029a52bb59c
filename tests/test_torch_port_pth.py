"""PyTorch port: a reference checkpoint (`.pth`) loads through `load_pth`.

No reference weights are in the repository, so each file is written by the test:
the JAX package's `export_progressive` / `export_rem` on params carried in
from the port's seeded `init_params` (`import_progressive` / `import_rem`),
every key under DataParallel's `module.` prefix, wrapped in
`{"state_dict": ...}`, plus a dummy tensor for every buffer name upstream
CompressAI registers that the port does not hold (`REFERENCE_BUFFERS`, on
the bottleneck, a GaussianConditional and a GDN), `torch.save`d to a
temporary directory.  `load_pth` must give tensors equal to
`from_jax_params` on the same params, and the model must load them with
`strict=True`; a stray key and a missing key must still raise.  JAX only
reshapes numpy arrays in this file: nothing is compiled.
"""

import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models.torch_import import (
    export_progressive,
    export_rem,
    import_progressive,
    import_rem,
)

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import (
    REFERENCE_BUFFERS,
    from_jax_params,
    init_params,
    load_pth,
    strip_prefixes,
)

TINY_KW = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
# the modules of a reference model that own each kind of buffer
BUFFER_OWNERS = ("entropy_bottleneck", "gaussian_conditional", "g_a.0.1")


def tiny(name):
    kw = {"name": name, **TINY_KW}
    return (ModelConfig(**kw, scale_table=ScaleTableConfig(levels=32)),
            JaxModelConfig(**kw, scale_table=JaxScaleTableConfig(levels=32)))


def reference_file(name, tmp_path, extra=None, drop=None):
    """(path of a reference-style checkpoint of the TINY model `name`, the
    state dict `from_jax_params` gives on the same params)."""
    cfg, jcfg = tiny(name)
    importer, exporter = {"channel": (import_progressive, export_progressive),
                          "rate": (import_rem, export_rem)}[name]
    sd = init_params(cfg, torch.Generator().manual_seed(3))
    params = importer({k: v.numpy() for k, v in sd.items()}, jcfg)
    ref = {f"module.{k}": torch.from_numpy(np.array(v)) for k, v in exporter(params, jcfg).items()}
    for owner in BUFFER_OWNERS:
        for buf in REFERENCE_BUFFERS:
            ref[f"module.{owner}.{buf}"] = torch.zeros(3, dtype=torch.int32)
    ref.update(extra or {})
    if drop:
        del ref[drop]
    path = tmp_path / f"{name}.pth"
    torch.save({"state_dict": ref, "epoch": 7}, path)
    return path, from_jax_params(params, cfg)


@pytest.mark.parametrize("name", ["channel", "rate"])
def test_load_pth_matches_from_jax_params(name, tmp_path):
    path, want = reference_file(name, tmp_path)
    got = load_pth(str(path), tiny(name)[0])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    model = get_model(tiny(name)[0], device="cpu")
    model.load_state_dict(got, strict=True)
    # the dict form loads the same way
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    assert set(load_pth(loaded, tiny(name)[0])) == set(want)


@pytest.mark.parametrize("fault", ["unknown", "missing"])
def test_load_pth_still_refuses(fault, tmp_path):
    """Only the named buffers are dropped: any other unknown key, and any
    missing one, raises."""
    if fault == "unknown":
        path, _ = reference_file("channel", tmp_path,
                                 extra={"module.g_a.0.0.running_mean": torch.zeros(3)})
        match = "Unexpected key"
    else:
        path, _ = reference_file("channel", tmp_path, drop="module.h_a.0.bias")
        match = "Missing key"
    with pytest.raises(RuntimeError, match=match):
        load_pth(str(path), tiny("channel")[0])


def test_strip_prefixes():
    sd = {"module.a.weight": 1, "b.module.c": 2, "module.module.d": 3}
    assert strip_prefixes(sd) == {"a.weight": 1, "b.module.c": 2, "module.d": 3}
