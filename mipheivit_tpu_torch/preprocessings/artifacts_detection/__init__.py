"""Artifact filtering's first step (the port's copy of
``preprocessings/artifacts_detection/extract_embeddings.py``): the
foundation encoder's class token per tile, into ``.npy`` shards."""
