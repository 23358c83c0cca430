"""Parser of the bf.map expression language (the port's own copy of
``bifrost_tpu/ops/map_lang.py``; pure Python).

The reference bfMap JIT engine generates CUDA C from user expression
strings at runtime via NVRTC (reference: src/map.cpp:110-406, 630-797).
Here the *same user-facing language* is parsed into an AST, which
:mod:`bifrost_tpu_torch.ops.map` evaluates with torch ops on the
tensors' device.

Supported language (the contract is defined by the reference's call sites,
reference: src/map.cpp:29-35 examples, blocks/detect.py:85-138,
blocks/convert_visibilities.py:99-165, test/test_map.py):

- statements separated by ';', '//' and '/* */' comments, simple
  function-like ``#define`` macros
- declarations: ``auto x = ...``, ``b_type x = ...``,
  ``Complex<b_type> x = ...``, ``T y(a, b)`` constructor form
- assignment (also ``+= -= *= /=``) to data arrays, either whole
  (``y = x+1``) or indexed (``b(i,j) = a(j,i)``)
- named-axis indexing ``a(i,j,k)`` plus the implicit index vector ``_``
  with per-axis arithmetic (``a(_-a.shape()/2)`` = fftshift), wrapping
  negative indices
- complex support: ``.real .imag .conj() .mag2() .phase()``,
  ``lval.assign(re, im)``, ``Complex<T>(x)`` construction
- vector types (``x[0]``, ``T(a,b,c,d)`` construction,
  ``T::value_type``)
- vectorized ``if``/``else`` (both branches evaluated, merged with
  torch.where — the SIMT semantics of the CUDA original)
- C-style semantics: integer '/' truncates toward zero; float literal
  suffixes (``2.f``); ``int()``/``float()``/casts; ternary ``?:``;
  ``&& || !``; math functions (abs, sqrt, rint, pow, exp, log, floor,
  ceil, min, max, ...)
"""

from __future__ import annotations

import re


__all__ = ['compile_map', 'MapSyntaxError']


class MapSyntaxError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<float>   \d+\.\d*(?:[eE][+-]?\d+)?[fF]? | \.\d+(?:[eE][+-]?\d+)?[fF]?
               | \d+(?:[eE][+-]?\d+)[fF]? | \d+[fF] )
  | (?P<int>     0[xX][0-9a-fA-F]+ | \d+ )
  | (?P<name>    [A-Za-z_][A-Za-z0-9_]* (?: :: [A-Za-z_][A-Za-z0-9_]* )? )
  | (?P<op>      \+= | -= | \*= | /= | == | != | <= | >= | && | \|\| | << | >>
               | [-+*/%=<>!?:;,.()\[\]{}~&|^] )
  | (?P<ws>      \s+ )
""", re.VERBOSE)


def _strip_comments(src):
    src = re.sub(r'/\*.*?\*/', ' ', src, flags=re.DOTALL)
    src = re.sub(r'//[^\n]*', ' ', src)
    return src


def _expand_defines(src):
    """Expand simple function-like #define macros textually (the reference
    relies on the C preprocessor; we support the same single-line form)."""
    out_lines = []
    macros = []
    for line in src.split('\n'):
        m = re.match(r'\s*#\s*define\s+(\w+)\(([^)]*)\)\s+(.*)', line)
        if m:
            name, params, body = m.group(1), m.group(2), m.group(3)
            params = [p.strip() for p in params.split(',')]
            macros.append((name, params, body.strip()))
            continue
        m = re.match(r'\s*#\s*define\s+(\w+)\s+(.*)', line)
        if m:
            macros.append((m.group(1), None, m.group(2).strip()))
            continue
        out_lines.append(line)
    src = '\n'.join(out_lines)
    for name, params, body in macros:
        if params is None:
            src = re.sub(r'\b%s\b' % re.escape(name), '(%s)' % body, src)
        else:
            # repeatedly expand NAME(arg, ...) occurrences
            pat = re.compile(r'\b%s\s*\(' % re.escape(name))
            while True:
                m = pat.search(src)
                if not m:
                    break
                # find matching close paren
                depth, i = 1, m.end()
                args, cur = [], []
                while depth:
                    c = src[i]
                    if c == '(':
                        depth += 1
                    elif c == ')':
                        depth -= 1
                        if depth == 0:
                            break
                    elif c == ',' and depth == 1:
                        args.append(''.join(cur))
                        cur = []
                        i += 1
                        continue
                    cur.append(c)
                    i += 1
                args.append(''.join(cur))
                expansion = body
                for p, a in zip(params, args):
                    expansion = re.sub(r'\b%s\b' % re.escape(p),
                                       '(%s)' % a.strip(), expansion)
                src = src[:m.start()] + '(%s)' % expansion + src[i + 1:]
    return src


def tokenize(src):
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise MapSyntaxError("Bad token at: %r" % src[pos:pos + 20])
        pos = m.end()
        kind = m.lastgroup
        if kind == 'ws':
            continue
        tokens.append((kind, m.group()))
    tokens.append(('eof', ''))
    return tokens


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class Node(object):
    _fields = ()

    def __init__(self, *args):
        for name, val in zip(self._fields, args):
            setattr(self, name, val)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__,
                           ', '.join(repr(getattr(self, f))
                                     for f in self._fields))


class Num(Node):
    _fields = ('value', 'is_float', 'is_f32')


class Name(Node):
    _fields = ('id',)


class BinOp(Node):
    _fields = ('op', 'left', 'right')


class UnOp(Node):
    _fields = ('op', 'operand')


class Ternary(Node):
    _fields = ('cond', 'then', 'other')


class CallIndex(Node):      # a(i, j)
    _fields = ('base', 'args')


class Subscript(Node):      # x[0]
    _fields = ('base', 'index')


class Method(Node):         # x.conj(), a.shape()
    _fields = ('base', 'name', 'args')


class Attr(Node):           # x.real
    _fields = ('base', 'name')


class Cast(Node):           # (b_type)x, int(x)
    _fields = ('type_name', 'operand')


class Ctor(Node):           # Complex<T>(a[, b]), T(a,b,c,d)
    _fields = ('type_name', 'args')


class Decl(Node):           # auto x = expr / T x(args)
    _fields = ('type_name', 'name', 'expr')


class Assign(Node):         # lval op= expr
    _fields = ('target', 'op', 'expr')


class AssignCall(Node):     # lval.assign(re, im)
    _fields = ('target', 'args')


class If(Node):
    _fields = ('cond', 'then_body', 'else_body')


_TYPE_WORDS = {'auto', 'int', 'float', 'double', 'bool', 'long', 'short',
               'signed', 'unsigned', 'char'}

_RESERVED = {'if', 'else', 'true', 'false', 'return'}


class Parser(object):
    def __init__(self, tokens, type_names):
        self.toks = tokens
        self.i = 0
        self.type_names = type_names  # e.g. {'a_type', 'b_type', ...}

    # -- token helpers ----------------------------------------------------
    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, value):
        if self.peek()[1] == value and self.peek()[0] != 'eof':
            return self.next()
        return None

    def expect(self, value):
        t = self.next()
        if t[1] != value:
            raise MapSyntaxError("Expected %r, got %r" % (value, t[1]))
        return t

    def at_type_name(self):
        kind, val = self.peek()
        if kind != 'name':
            return False
        if val in _TYPE_WORDS or val in self.type_names:
            return True
        if val.endswith('_type') or '::' in val:
            return True
        if val == 'Complex':
            return True
        return False

    def parse_type_name(self):
        """Parse a (possibly templated) type name into a string."""
        parts = [self.next()[1]]
        # multi-word: unsigned int etc
        while self.peek()[0] == 'name' and self.peek()[1] in _TYPE_WORDS \
                and parts[0] in ('signed', 'unsigned', 'long', 'short'):
            parts.append(self.next()[1])
        name = ' '.join(parts)
        if self.accept('<'):
            inner = self.parse_type_name()
            self.expect('>')
            name = '%s<%s>' % (name, inner)
        return name

    # -- statements -------------------------------------------------------
    def parse_program(self):
        body = []
        while self.peek()[0] != 'eof':
            body.append(self.parse_stmt())
        return body

    def parse_block(self):
        if self.accept('{'):
            body = []
            while not self.accept('}'):
                if self.peek()[0] == 'eof':
                    raise MapSyntaxError("Unclosed '{'")
                body.append(self.parse_stmt())
            return body
        return [self.parse_stmt()]

    def parse_stmt(self):
        kind, val = self.peek()
        if val == ';':
            self.next()
            return None
        if val == 'if':
            self.next()
            self.expect('(')
            cond = self.parse_expr()
            self.expect(')')
            then_body = self.parse_block()
            else_body = []
            if self.accept('else'):
                else_body = self.parse_block()
            return If(cond, [s for s in then_body if s],
                      [s for s in else_body if s])
        # declaration?
        if kind == 'name' and val not in _RESERVED and self.at_type_name():
            # lookahead: type name followed by identifier
            save = self.i
            tname = self.parse_type_name()
            if self.peek()[0] == 'name' and self.peek(1)[1] in ('=', '(', ',', ';'):
                stmts = []
                while True:
                    ident = self.next()[1]
                    if self.accept('('):
                        args = self.parse_args()
                        stmts.append(Decl(tname, ident,
                                          Ctor(tname, args)))
                    elif self.accept('='):
                        stmts.append(Decl(tname, ident, self.parse_expr()))
                    else:
                        stmts.append(Decl(tname, ident, None))
                    if not self.accept(','):
                        break
                self.accept(';')
                if len(stmts) == 1:
                    return stmts[0]
                return If(Num(1, False, False), stmts, [])  # inline group
            self.i = save  # not a decl after all
        # assignment or expression
        expr = self.parse_expr()
        t = self.peek()[1]
        if t in ('=', '+=', '-=', '*=', '/='):
            self.next()
            rhs = self.parse_expr()
            self.accept(';')
            return Assign(expr, t, rhs)
        if isinstance(expr, Method) and expr.name == 'assign':
            self.accept(';')
            return AssignCall(expr.base, expr.args)
        self.accept(';')
        return Assign(None, '=', expr)  # bare expression

    # -- expressions ------------------------------------------------------
    def parse_args(self):
        args = []
        if self.accept(')'):
            return args
        while True:
            args.append(self.parse_expr())
            if self.accept(')'):
                return args
            self.expect(',')

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_or()
        if self.accept('?'):
            then = self.parse_expr()
            self.expect(':')
            other = self.parse_expr()
            return Ternary(cond, then, other)
        return cond

    def parse_or(self):
        node = self.parse_and()
        while self.accept('||'):
            node = BinOp('||', node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_bitor()
        while self.accept('&&'):
            node = BinOp('&&', node, self.parse_bitor())
        return node

    def parse_bitor(self):
        node = self.parse_bitxor()
        while self.peek()[1] == '|':
            self.next()
            node = BinOp('|', node, self.parse_bitxor())
        return node

    def parse_bitxor(self):
        node = self.parse_bitand()
        while self.peek()[1] == '^':
            self.next()
            node = BinOp('^', node, self.parse_bitand())
        return node

    def parse_bitand(self):
        node = self.parse_cmp()
        while self.peek()[1] == '&':
            self.next()
            node = BinOp('&', node, self.parse_cmp())
        return node

    def parse_cmp(self):
        node = self.parse_shift()
        while self.peek()[1] in ('==', '!=', '<', '<=', '>', '>='):
            # avoid consuming '>' of a template — templates are handled in
            # parse_type_name, so '>' here is comparison
            op = self.next()[1]
            node = BinOp(op, node, self.parse_shift())
        return node

    def parse_shift(self):
        node = self.parse_add()
        while self.peek()[1] in ('<<', '>>'):
            op = self.next()[1]
            node = BinOp(op, node, self.parse_add())
        return node

    def parse_add(self):
        node = self.parse_mul()
        while self.peek()[1] in ('+', '-'):
            op = self.next()[1]
            node = BinOp(op, node, self.parse_mul())
        return node

    def parse_mul(self):
        node = self.parse_unary()
        while self.peek()[1] in ('*', '/', '%'):
            op = self.next()[1]
            node = BinOp(op, node, self.parse_unary())
        return node

    def parse_unary(self):
        t = self.peek()[1]
        if t in ('-', '+', '!', '~'):
            self.next()
            return UnOp(t, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        node = self.parse_primary()
        while True:
            if self.accept('('):
                args = self.parse_args()
                if isinstance(node, Name):
                    node = CallIndex(node, args)
                else:
                    raise MapSyntaxError("Cannot call %r" % node)
            elif self.accept('['):
                idx = self.parse_expr()
                self.expect(']')
                node = Subscript(node, idx)
            elif self.accept('.'):
                name = self.next()[1]
                if self.accept('('):
                    args = self.parse_args()
                    node = Method(node, name, args)
                else:
                    node = Attr(node, name)
            else:
                return node

    def parse_primary(self):
        kind, val = self.peek()
        if kind == 'float':
            self.next()
            is_f32 = val[-1] in 'fF'
            return Num(float(val.rstrip('fF')), True, is_f32)
        if kind == 'int':
            self.next()
            return Num(int(val, 0), False, False)
        if val == '(':
            # cast or parenthesized expression
            save = self.i
            self.next()
            if self.at_type_name():
                tname = self.parse_type_name()
                if self.accept(')'):
                    # (T)expr cast — but beware "(b)" where b is data;
                    # only treat as cast for explicit type names
                    return Cast(tname, self.parse_unary())
                self.i = save
                self.next()
            expr = self.parse_expr()
            self.expect(')')
            return expr
        if kind == 'name':
            if val == 'true':
                self.next()
                return Num(1, False, False)
            if val == 'false':
                self.next()
                return Num(0, False, False)
            if val == 'Complex' or val.endswith('_type') or '::' in val \
                    or val in self.type_names:
                # possible constructor: T(args)
                save = self.i
                tname = self.parse_type_name()
                if self.accept('('):
                    args = self.parse_args()
                    return Ctor(tname, args)
                self.i = save
            self.next()
            return Name(val)
        raise MapSyntaxError("Unexpected token %r" % val)


def parse(src, type_names=()):
    src = _expand_defines(_strip_comments(src))
    return Parser(tokenize(src), set(type_names)).parse_program()


def compile_map(func_string, data_names):
    """Parse ``func_string``; returns the statement list AST.  ``data_names``
    seeds the known ``<name>_type`` cast targets."""
    type_names = {n + '_type' for n in data_names}
    return parse(func_string, type_names)
