"""The distributed engine over ``torch.distributed``: the mesh context
(:mod:`~repro_torch.distributed.sharding`), distributed BWKM
(:mod:`~repro_torch.distributed.dist_bwkm`) and k-means||
(:mod:`~repro_torch.distributed.dist_kmeans_ll`)."""
