"""String enums (counterpart of ``metrics_tpu/utils/enums.py``)."""

from __future__ import annotations

from enum import Enum


class EnumStr(str, Enum):
    """Enumerator that compares equal to its value as a case-insensitive string.

    >>> ClassificationTask.from_str("Binary") == ClassificationTask.BINARY
    True
    """

    @staticmethod
    def _name() -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str) -> "EnumStr":
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError as err:
            _allowed = [m.lower() for m in cls._member_names_]
            raise ValueError(f"Invalid {cls._name()}: expected one of {_allowed}, but got {value}.") from err

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Enum):
            other = other.value
        return self.value.lower() == str(other).lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class ClassificationTask(EnumStr):
    """The classification tasks.

    >>> "binary" in list(ClassificationTask)
    True
    """

    @staticmethod
    def _name() -> str:
        return "Classification"

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoBinary(EnumStr):
    """The classification tasks but binary."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoMultilabel(EnumStr):
    """The classification tasks but multilabel."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    BINARY = "binary"
    MULTICLASS = "multiclass"
