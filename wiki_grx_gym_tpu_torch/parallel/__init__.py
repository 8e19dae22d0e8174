"""Data- and tensor-parallel training over ``torch.distributed`` (port of
``wiki_grx_gym_tpu/parallel/``)."""
