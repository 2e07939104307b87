"""Device ops of the port: sparse batches, TF-IDF, LDA math and the three
hand-written CUDA kernels (E-step gamma fixed point, EM scatter, fused EM
sweep), each beside its plain PyTorch version."""
