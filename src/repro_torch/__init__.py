"""PyTorch/CUDA port of the SUPG selection system (the JAX package
`repro` is the reference). Layout and public names mirror `repro`:
`repro_torch.core.engine.SelectionEngine` answers RT/PT/JT queries over a
device-resident corpus through the hand-written kernels in
`repro_torch.kernels` (CUDA sources in ``csrc/``); `repro_torch.random`
keeps jax-format threefry keys so one key drives both packages."""
