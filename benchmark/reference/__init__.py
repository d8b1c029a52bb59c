"""The plain references the benchmark holds the program to.

`coder.py` is the NumPy entropy coder and container, shared by every
configuration.  Every other module here is the plain reference of one model
architecture, in plain PyTorch and NumPy: it imports neither JAX, nor the
JAX package, nor anything of the program under test.

A configuration file names its reference by stem, `"reference": "<stem>"`
for `benchmark/reference/<stem>.py`; without the key it is `model`.  The
harness loads that file from the checkout once per run (`harness.reference`)
and uses the one module object for the program's weights, the comparison,
the control and the yardstick's counts.  So a new architecture comes with a
new file here and a configuration naming it, and no file the benchmark has
changes.

A reference module provides:

  Cfg(model)
      the configuration file's "model" object as the reference reads it,
      exposing at least `N` (z's channel count: the entropy bottleneck's
      medians, and the number of bottleneck rows ahead of the Gaussian rows
      in the merged CDF table) and `scale_table` (float64, the Gaussian
      conditional's scales).
  param_spec(cfg) -> [(state-dict name, shape, kind)]
      every weight of the model under the program's state-dict names, in a
      fixed order; `benchmark/weights.py` draws each by its kind.  The
      entropy bottleneck's tensors are named `...entropy_bottleneck.<leaf>`.
  reference_request(P, cfg, x, quality, medians=None)
      -> {"stages": [(symbols, rows, keep)], "y_hat", "x_hat"}
      one request: x (B, H, W, 3) in [0, 1] at `quality` gives the coder's
      stages in the container's coding order (flat int32 symbols, int32
      rows of the merged table, bool keep flags; the first stage is z), the
      synthesis input channel-last, and the clipped reconstruction
      (B, H, W, 3).  `medians` replaces the bottleneck's medians (the
      FLOP count passes meta tensors).  Convolutions and products go
      through `torch.nn.functional`, where the control's channels-last
      variant replaces them.
  stage_sizes(cfg, batch, h, w, quality) -> [int]
      symbols per container stage, in coding order.
  chain_flops(cfg, batch, h, w, quality) -> int
      the FLOPs one round trip needs (the encoder's and the decoder's
      halves), counted on the reference over meta tensors.

and may declare

  INIT_KINDS = {kind: {"std": s} | {"const": c}}
      initialisers for the kinds its `param_spec` names: a normal draw at
      std `s`, or the constant `c`, in the same batched and seeded calls as
      the built-in kinds (`benchmark/weights.py`: conv, deconv, linear,
      relpos, bias, ones, GDN's and the entropy bottleneck's).  A kind
      declared here is drawn this way even where a built-in one has its name.
"""
