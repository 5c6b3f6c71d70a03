"""Training: AdamW over float32 masters, the microbatched train step, the
random-walk corpus on the port's generators, checkpoint / restart and the
int8 data-parallel gradient sync (the JAX package's ``train/``)."""
