"""PyTorch port vs the JAX package: the ChannelProgressiveWACNN variants
on the unrolled path with all_scalable + support_std, the learnable mask
or total_mu_rep.  What is checked, and why the variants are spread over four files:
tests/test_torch_port_variants.py.
"""

import pytest
from test_torch_port_variants import (
    NO_JAX,
    VARIANTS,
    build_variant,
    check_fragments_and_bytes,
    check_weights,
    image,
    one_torch_thread,  # noqa: F401  (autouse)
    qualities,
    roundtrip,
)

HERE = ["all_scalable_support_std", "learnable_double_dim", "total_mu_rep"]


@pytest.fixture(scope="module", params=HERE)
def variant(request):
    return (request.param, *build_variant(request.param))


@pytest.mark.parametrize("groups", [1, 2])
def test_variant_roundtrip_bit_exact(variant, groups):
    name, model, _, _ = variant
    for q in qualities(VARIANTS[name]):
        roundtrip(model, image(3), q, groups)


@pytest.mark.parametrize("variant", [n for n in HERE if n not in NO_JAX], indirect=True)
def test_variant_fragments_and_bytes_match_jax(variant, monkeypatch):
    name, model, jcodec, _ = variant
    check_fragments_and_bytes(model, jcodec, qualities(VARIANTS[name])[0], monkeypatch)


def test_variant_weights_map_like_export_progressive(variant):
    check_weights(variant[0], variant[1], variant[3])
