"""Accuracy comparators."""
