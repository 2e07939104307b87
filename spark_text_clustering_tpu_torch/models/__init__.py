"""Models of the port: ``LDAModel``, the EM optimizer, persistence."""
