"""Temporal-parallel filtering and smoothing, and banks of filters."""
