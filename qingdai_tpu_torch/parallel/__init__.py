"""Multi-GPU: the flagship planet sharded over longitude and the ensemble
sharded over members (port of ``qingdai_tpu/parallel``).

``mesh`` builds the layout and cuts state and statics into shards, ``halo``
holds the collectives the sharded step calls, ``dryrun`` compares a sharded
run against the unsharded one."""
