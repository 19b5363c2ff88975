"""The loops that serve a cell, one file each: ``run(ctx) -> record``."""
