"""Chinese number verbalization (capability match for thirdparty/zh_num.py).

Self-contained implementation of Mandarin numeral reading: integers with
十/百/千/万/亿 grouping, decimals (点 + digitwise), negatives (负),
fractions (分之), percentages (百分之) and ranges.
"""

import re
from typing import List

DIGITS = "零一二三四五六七八九"
UNITS = ["", "十", "百", "千"]
GROUP_UNITS = ["", "万", "亿", "万亿"]


def _four_digits(num: int) -> str:
    """0..9999 -> hanzi, without leading-zero collapse across groups."""
    if num == 0:
        return ""
    out = []
    pending_zero = False
    for pos in range(3, -1, -1):
        digit = (num // 10 ** pos) % 10
        if digit == 0:
            if out:
                pending_zero = True
            continue
        if pending_zero:
            out.append("零")
            pending_zero = False
        out.append(DIGITS[digit] + UNITS[pos])
    return "".join(out)


def num2zh(num: int) -> str:
    """Integer -> hanzi reading (二十, 一百零五, 三万二千, ...)."""
    if num < 0:
        return "负" + num2zh(-num)
    if num == 0:
        return "零"

    groups: List[int] = []
    while num > 0:
        groups.append(num % 10000)
        num //= 10000
    out = ""
    for idx in range(len(groups) - 1, -1, -1):
        part = groups[idx]
        if part == 0:
            continue
        text = _four_digits(part)
        # 1000-group boundary zero: 一亿零五 etc.
        if out and part < 1000:
            out += "零"
        out += text + GROUP_UNITS[idx]
    # Conventional reading: 一十X -> 十X
    if out.startswith("一十"):
        out = out[1:]
    return out


def digits2zh(digits: str) -> str:
    """Digit string read digit-by-digit (phone numbers, decimals)."""
    return "".join(DIGITS[int(d)] for d in digits if d.isdigit())


_PERCENT_RE = re.compile(r"^(-?)(\d+(?:\.\d+)?)%$")
_FRACTION_RE = re.compile(r"^(-?)(\d+)/(\d+)$")
_RANGE_RE = re.compile(r"^(\d+(?:\.\d+)?)[-~](\d+(?:\.\d+)?)$")
_DECIMAL_RE = re.compile(r"^(-?)(\d+)\.(\d+)$")
_INT_RE = re.compile(r"^(-?)(\d+)$")


def _number(sign: str, value: str) -> str:
    prefix = "负" if sign else ""
    if "." in value:
        int_part, frac_part = value.split(".")
        return prefix + num2zh(int(int_part)) + "点" + digits2zh(frac_part)
    return prefix + num2zh(int(value))


def num2str(value: str) -> str:
    """Numeric string -> spoken Mandarin (mirrors zh_num.num2str)."""
    value = value.strip()
    match = _PERCENT_RE.match(value)
    if match:
        sign, number = match.groups()
        return ("负" if sign else "") + "百分之" + _number("", number)
    match = _FRACTION_RE.match(value)
    if match:
        sign, numerator, denominator = match.groups()
        return (("负" if sign else "")
                + num2zh(int(denominator)) + "分之" + num2zh(int(numerator)))
    match = _RANGE_RE.match(value)
    if match:
        low, high = match.groups()
        return _number("", low) + "到" + _number("", high)
    match = _DECIMAL_RE.match(value)
    if match:
        sign, int_part, frac_part = match.groups()
        return _number(sign, f"{int_part}.{frac_part}")
    match = _INT_RE.match(value)
    if match:
        sign, number = match.groups()
        return _number(sign, number)
    return value
