"""Generators and their building blocks: RNG, factions, spec, PBA."""
