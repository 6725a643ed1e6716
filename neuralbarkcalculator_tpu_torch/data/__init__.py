"""Folder manifests and image load/save helpers."""
