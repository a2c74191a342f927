"""The plain reference: numpy and plain torch, independent of the port.

Nothing here imports the port, the JAX package or JAX. The pieces are
frozen copies of the arithmetic the benchmark holds the port to (the ZINC
stand-in generator, the SENT trail tokenizer and its ZINC remap, first-fit
packing, the counter hashes of the dropout sites, the optimizer) and a
plain forward of the token transformer.
"""
