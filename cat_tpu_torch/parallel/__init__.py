"""Data-parallel training over several processes (port of
cat_tpu/parallel/): ``distributed`` sets up the process group, ``mesh``
holds the env axis's collectives and the split of the state into
env-batched and replicated leaves."""
