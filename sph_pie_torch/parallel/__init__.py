"""Spatial domain decomposition: meshes of shards, the sharded, halo and
balanced WCSPH steps, sharded PBF, and the multi-device dry run."""
