"""Sharding layouts and the explicit SPMD of the port: the reference's
specs and ZeRO layouts as DTensor placements (``specs.py``, with the
fabric layouts), the collectives of the sharded paths (``comm.py``) and
the expert-parallel MoE layer (``ep.py``)."""
