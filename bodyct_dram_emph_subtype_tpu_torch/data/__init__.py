"""Numpy host data layer: MetaImage codec, thread loader, datasets."""
