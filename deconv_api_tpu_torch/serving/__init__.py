"""Serving of the port: host codec, model bundles, the HTTP service."""
