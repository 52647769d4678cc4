"""DAnA few-shot detection in PyTorch, with hand-written CUDA kernels for
Hopper (sm_90a).

A port of the JAX package `dana_tpu` that keeps its layout (`core/`,
`ops/`, `models/`, `engine/`, `utils/`) so each module's counterpart is
found by name, and keeps its tensor layout (NHWC images, features and
supports) at every public function.  This package imports torch and
numpy only.

Entry points: `dana_tpu_torch.engine.predict.Predictor`,
`dana_tpu_torch.engine.train.Trainer` and the two CLIs
(`python -m dana_tpu_torch.inference`, `python -m dana_tpu_torch.train`),
for DAnA and the frameworks of `models/frameworks.py`.
"""
