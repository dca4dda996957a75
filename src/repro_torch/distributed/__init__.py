"""Sharding rules and their DTensor placements (``sharding``)."""
