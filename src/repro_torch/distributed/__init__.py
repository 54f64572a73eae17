"""Fault-tolerant training and gradient compression on one device."""
