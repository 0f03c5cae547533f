"""CLIP towers (ViT, text) as plain functions over parameter dicts."""
