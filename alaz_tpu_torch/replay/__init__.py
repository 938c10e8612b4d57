"""Replay inputs: synthetic service-map windows and the traffic
``Simulator``."""
