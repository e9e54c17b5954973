"""Sharding rules (``partition``) and the models' activation hook (``api``)."""
