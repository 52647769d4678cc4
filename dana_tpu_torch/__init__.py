"""DAnA few-shot detection in PyTorch, with hand-written CUDA kernels for
Hopper (sm_90a).

A port of the JAX package `dana_tpu` that keeps its layout (`core/`,
`ops/`, `models/`, `engine/`, `utils/`) so each module's counterpart is
found by name, and keeps its tensor layout (NHWC images, features and
supports) at every public function.  This package imports torch and
numpy only.

Entry point: `dana_tpu_torch.engine.predict.Predictor`.
"""
