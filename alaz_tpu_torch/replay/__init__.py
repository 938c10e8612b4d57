"""Replay inputs: synthetic service-map windows."""
