"""Brick-mesh domain decomposition: one rank per brick over torch.distributed."""
