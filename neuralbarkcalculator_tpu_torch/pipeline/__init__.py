"""Folder preprocess, prediction engine and artifact writers."""
