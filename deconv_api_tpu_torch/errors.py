"""The HTTP error taxonomy the slice serves (the codes of
``deconv_api_tpu/errors.py``): each error maps to a status and a
machine-readable code, served as ``{"error": code, "detail": message}``."""

from __future__ import annotations


class DeconvError(Exception):
    status = 500
    code = "internal_error"

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message

    def payload(self) -> dict:
        return {"error": self.code, "detail": self.message}


class BadRequest(DeconvError):
    status = 400
    code = "bad_request"


class InvalidImage(BadRequest):
    code = "invalid_image"


class UnknownLayer(DeconvError):
    status = 422
    code = "unknown_layer"


class UnknownModel(DeconvError):
    """The request names a model this server does not serve."""

    status = 422
    code = "unknown_model"


class IllegalMode(DeconvError):
    status = 422
    code = "illegal_visualize_mode"


class NoActiveFilters(DeconvError):
    """No filter fired for the requested layer."""

    status = 422
    code = "no_active_filters"


class ModelNotReady(DeconvError):
    status = 503
    code = "model_not_ready"


class RequestTimeout(DeconvError):
    status = 504
    code = "request_timeout"


class Unavailable(DeconvError):
    """A model's weights could not be brought onto the device in time."""

    status = 503
    code = "unavailable"
