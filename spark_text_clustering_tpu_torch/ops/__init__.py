"""Device ops of the port: sparse batches, TF-IDF, LDA math and the six
hand-written CUDA kernels (padded and token-packed E-step gamma fixed
points, EM scatter, fused EM sweep, NMF tile W update, the per-document
frozen fixed point of scoring), each beside its plain PyTorch version."""
