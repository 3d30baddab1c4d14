"""The proxy-scorer model plane: dense GQA transformers, hybrid Mamba2
models (Zamba2) and RWKV6 models that map records (token streams) to proxy
scores A(x) and decode against KV and recurrent-state caches (the JAX
package's ``models/``)."""
