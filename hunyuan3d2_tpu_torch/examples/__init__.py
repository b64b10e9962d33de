"""The reference's example scripts on the PyTorch port, one file per
examples/*.py with the same name and the same output files. Each runs as
``python -m hunyuan3d2_tpu_torch.examples.<name> [--device cpu]`` or through
its ``main(device=...)``; ``HY3D_RANDOM_WEIGHTS=1`` takes tiny random-weight
pipelines (a GLB in seconds on the CPU) in place of the published
checkpoints."""
