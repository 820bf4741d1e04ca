"""Training across devices. One device so far: the wide family's fit
(:mod:`.retrain`). The JAX package's serving mesh, sharded flushes and 2-D
retrain are ROADMAP item 12."""
