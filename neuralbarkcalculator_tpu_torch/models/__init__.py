"""Dilated ResNet + FCN head, BN folding and weight conversion."""
