"""Request-level exceptions (parity: reference server/dpow/exceptions.py)."""


class InvalidRequest(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class RequestTimeout(Exception):
    pass


class RetryRequest(Exception):
    pass
