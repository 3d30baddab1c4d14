"""The proxy-scorer model plane: dense GQA transformers and hybrid Mamba2
models (Zamba2) that map records (token streams) to proxy scores A(x) (the
JAX package's ``models/``)."""
