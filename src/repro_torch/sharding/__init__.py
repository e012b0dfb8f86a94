"""Sharding layouts of the port.  Only the fabric layouts are here so far
(``specs.py``); the mesh / ZeRO layouts come with multi-device training."""
