"""The proxy-scorer model plane: dense GQA transformers that map records
(token streams) to proxy scores A(x) (the JAX package's ``models/``)."""
