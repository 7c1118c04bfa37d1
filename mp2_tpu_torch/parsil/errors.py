"""Typed validation errors for the SQL front-end.

Role of parsil/src/errors.rs (ValidationError enum): every way a query can
fall outside the supported ZK-SQL subset gets its own error type, so
callers (and the golden corpus in tests/test_parsil_validate.py) can
assert on the REASON a query was rejected, not just that it was.

A jax-free copy of `mp2_tpu/parsil/errors.py`: only the imports change.
"""

from __future__ import annotations


class ValidationError(ValueError):
    """Base class for all front-end rejections (parsil/src/errors.rs)."""


class MixedQuery(ValidationError):
    def __init__(self):
        super().__init__(
            "query projection must not mix aggregates and scalars"
        )


class NotASelect(ValidationError):
    def __init__(self, what: str = ""):
        super().__init__(f"query body should be a SELECT statement {what}".strip())


class UnsupportedUnaryOperator(ValidationError):
    def __init__(self, op: str):
        super().__init__(f"`{op}`: unsupported operator")
        self.op = op


class UnsupportedBinaryOperator(ValidationError):
    def __init__(self, op: str):
        super().__init__(f"`{op}`: unsupported operator")
        self.op = op


class UnknownFunction(ValidationError):
    def __init__(self, name: str):
        super().__init__(f"`{name}`: unknown function")
        self.name = name


class InvalidArity(ValidationError):
    def __init__(self, name: str, expected: int, found: int):
        super().__init__(
            f"`{name}`: expected {expected} argument, found {found}"
        )


class InvalidFunctionArgument(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"`{what}`: unexpected argument type")


class UnknownPlaceholder(ValidationError):
    def __init__(self, name: str):
        super().__init__(f"`{name}`: unknown placeholder")
        self.name = name


class MissingPlaceholder(ValidationError):
    def __init__(self, name: str):
        super().__init__(f"`{name}` is not used")


class TooManyParameters(ValidationError):
    def __init__(self, expected: int, got: int):
        super().__init__(
            f"Too many query parameters. Expected {expected}, got {got}"
        )


class UnsupportedImmediateValue(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"`{what}`: unsupported immediate value")


class NestedSelect(ValidationError):
    def __init__(self, what: str = "subquery"):
        super().__init__(f"`{what}`: nested selects are not supported")


class SetOperation(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"`{what}`: set operations are not supported")


class MutableQueries(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"`{what}`: mutable queries are not supported")


class UnsupportedFeature(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"{what} unsupported")
        self.feature = what


class UnsupportedJointure(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"`{what}`: unsupported jointure")


class NonStandardSql(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"`{what}`: non-standard SQL")


class OrderByArity(ValidationError):
    def __init__(self, what: str, max_n: int):
        super().__init__(
            f"`{what}`: ORDER BY only supports up to {max_n} criterions"
        )


class SpecialOrderBy(ValidationError):
    def __init__(self, what: str):
        super().__init__(
            "ORDER BY criterions must be present in the SELECT expressions; "
            f"`{what}` not found in SELECT"
        )


class CompoundTableName(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"`{what}`: compounded table names unsupported")


class ReservedIdentifier(ValidationError):
    def __init__(self, name: str):
        super().__init__(f"`{name}`: reserved identifier")


class InvalidInteger(ValidationError):
    def __init__(self, what: str):
        super().__init__(f"unable to convert `{what}` to a U256")


class NullRelatedOrdering(ValidationError):
    def __init__(self):
        super().__init__("NULL-related ordering specifiers unsupported")


class UseInvocationParameter(ValidationError):
    def __init__(self, clause: str):
        super().__init__(
            f"Clause `{clause}` value should be set in the appropriate "
            "parameter at execution time"
        )


class UnknownTable(ValidationError):
    def __init__(self, name: str):
        super().__init__(f"table `{name}` not found")


class UnknownColumn(ValidationError):
    def __init__(self, name: str, table: str):
        super().__init__(f"unknown column `{name}` in table `{table}`")


class TooManyOutputs(ValidationError):
    def __init__(self, got: int, max_n: int):
        super().__init__(
            f"too many SELECT items: {got} > MAX_NUM_ITEMS_PER_OUTPUT={max_n}"
        )


class TooManyPredicateOps(ValidationError):
    def __init__(self, got: int, max_n: int):
        super().__init__(
            f"WHERE clause needs {got} operations > "
            f"MAX_NUM_PREDICATE_OPS={max_n}"
        )


class TooManyResultOps(ValidationError):
    def __init__(self, got: int, max_n: int):
        super().__init__(
            f"SELECT expressions need {got} operations > "
            f"MAX_NUM_RESULT_OPS={max_n}"
        )


class MissingSecureBounds(ValidationError):
    def __init__(self, what: str):
        super().__init__(
            "primary index must be bounded by "
            f"{what} as top-level AND conjuncts "
            "(block >= $MIN_BLOCK AND block <= $MAX_BLOCK, or the "
            "equivalent BETWEEN)"
        )
