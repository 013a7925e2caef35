"""Render loops around the integrators (counterpart of
gradientdomain_mitsuba_tpu/parallel): checkpointed accumulation
(checkpoint), the row-sharded tile renderers over torch.distributed
(tiles), the distributed Poisson solve (dist_poisson), the elastic tile
queue (tile_queue) and the multi-process entry points (multihost)."""
