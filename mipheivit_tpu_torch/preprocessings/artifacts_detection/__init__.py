"""Artifact filtering (the port's copies of
``preprocessings/artifacts_detection``): ``extract_embeddings``, the
foundation encoder's class token per tile into ``.npy`` shards, and
``extract_if_artifact_props``, the artifact channels' per-tile shares."""
