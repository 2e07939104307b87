"""Models of the port: ``LDAModel``, the EM and online optimizers, NMF,
persistence."""
