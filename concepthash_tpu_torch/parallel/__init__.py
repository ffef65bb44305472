"""Data parallelism over ``torch.distributed`` (counterpart of
concepthash_tpu/parallel/): the process group and its mesh (``mesh``), and
the collectives with a gradient that keep every reduction over the batch
global (``collectives``).
"""
