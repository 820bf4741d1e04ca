"""The serving shell: stdlib HTTP app, micro-batcher, metrics, schemas."""
