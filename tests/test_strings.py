from autognothi.utils.strings import (
    flatten_dict,
    pattern_replace,
    pattern_replace_single,
    ranged_modulo_test,
)


def test_flatten_dict():
    assert flatten_dict({"a": {"b": 1, "c": {"d": 2}}, "e": 3}) == {
        "a.b": 1,
        "a.c.d": 2,
        "e": 3,
    }


def test_pattern_replace_single():
    repl = pattern_replace_single("format {this} and {that}", "into {that} and {this}")
    assert repl("format 1 and 2") == (True, "into 2 and 1")
    assert repl("long format 1 and 2") == (False, "long format 1 and 2")
    assert repl("no match") == (False, "no match")


def test_pattern_replace_fanout_and_identity():
    rules = {
        "format {this} and {that}": ["into {that} and {this}"],
        "multi {f}": ["a {f}", "b {f}"],
        "a{b}c": ["a{b}c"],
    }
    repl = pattern_replace(rules)
    assert repl("format 1 and 2") == (True, ["into 2 and 1"])
    assert repl("multi format") == (True, ["a format", "b format"])
    assert repl("a1c") == (True, ["a1c"])
    assert repl("no match") == (False, ["no match"])


def test_ranged_modulo_test():
    def check(patt, expected):
        fn = ranged_modulo_test(patt)
        got = "".join("*" if fn(i) else "." for i in range(len(expected)))
        assert got == expected

    check("<=10:%2==0; <=5:%3==1; <= 20 : %5 == 0", ".*..*.*.*.*....*....*")
    check(" <=6:%4==2 ;", "..*...*.......")
    check("<=5:%2==1; _:%3==0", ".*.*.**..*..*..*..")


def test_ranged_modulo_rejects_zero_modulus():
    import pytest

    with pytest.raises(ValueError, match="zero modulus"):
        ranged_modulo_test("_:%0==0")
