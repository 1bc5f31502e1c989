"""The parallel paths over torch.distributed: tile-sharded decode,
band-sharded in-loop filters with halo exchange, GOP fan-out, cross-frame
row overlap and the multi-host reference exchange (ports of
dav1d_mirror_tpu/parallel/). One process per rank; parallel/dryrun is
their entry point."""
