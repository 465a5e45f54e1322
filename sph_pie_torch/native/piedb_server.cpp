// piedb — a small networked document store for the sph-pie-torch service.
//
// Fills the role PostgreSQL plays for the reference platform
// (sphereisaiahmin-dev/sph-pie server/storage/postgresProvider.js): a real
// out-of-process storage server spoken to over TCP by a pooled client,
// with named databases (CREATE DATABASE on demand — the reference
// auto-creates its database when connect fails with SQLSTATE 3D000,
// postgresProvider.js:964-1033), per-connection transactions
// (BEGIN/COMMIT/ROLLBACK, :865-888) and durable table files.
//
// Wire protocol (request):   <OP> <db> <table> <key> <len>\n<payload[len]>
//   ops: PING CREATEDB DROPDB PUT GET DEL SCAN COUNT BEGIN COMMIT ROLLBACK
//   unused fields are "-". Identifiers must match [A-Za-z0-9_-]{1,64}
//   (the identifier-sanitization parity of postgresProvider.js:1052-1096).
// Response:  "OK <len>\n<payload>"  or  "ERR <CODE> <message>\n"
//   Missing database => ERR ENODB (the 3D000 analogue).
// SCAN payload: records of "<klen> <vlen>\n<key><value>" concatenated.
//
// Durability: one file per table under <data_dir>/<db>/<table>.tbl using
// the same record framing; rewritten atomically (tmp + rename) on commit.
// Concurrency: thread per connection, one coarse store mutex.
//
// Build: g++ -O2 -std=c++17 -pthread piedb_server.cpp -o piedb_server
// Run:   piedb_server <port> <data_dir>   (port 0 => ephemeral; the bound
//        port is printed as "LISTENING <port>" on stdout for test rigs)

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cctype>
#include <cstdio>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <map>
#include <mutex>
#include <optional>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace fs = std::filesystem;

static std::string g_data_dir;
static std::mutex g_mu;
// db -> table -> key -> value
static std::map<std::string, std::map<std::string, std::map<std::string, std::string>>> g_store;
static std::set<std::string> g_loaded_tables;  // "db/table" lazily loaded

static bool valid_ident(const std::string& s) {
  if (s.empty() || s.size() > 64) return false;
  for (char c : s)
    if (!(std::isalnum((unsigned char)c) || c == '_' || c == '-')) return false;
  return true;
}

static fs::path table_path(const std::string& db, const std::string& tbl) {
  return fs::path(g_data_dir) / db / (tbl + ".tbl");
}

static void load_table(const std::string& db, const std::string& tbl) {
  const std::string tag = db + "/" + tbl;
  if (g_loaded_tables.count(tag)) return;
  g_loaded_tables.insert(tag);
  std::ifstream in(table_path(db, tbl), std::ios::binary);
  if (!in) return;
  auto& t = g_store[db][tbl];
  std::string header;
  while (std::getline(in, header)) {
    size_t sp = header.find(' ');
    if (sp == std::string::npos) break;  // torn tail: stop at last good record
    size_t klen = std::stoul(header.substr(0, sp));
    size_t vlen = std::stoul(header.substr(sp + 1));
    std::string key(klen, '\0'), val(vlen, '\0');
    if (!in.read(&key[0], klen) || !in.read(&val[0], vlen)) break;
    t[key] = val;
  }
}

static void persist_table(const std::string& db, const std::string& tbl) {
  fs::path p = table_path(db, tbl);
  fs::create_directories(p.parent_path());
  fs::path tmp = p;
  tmp += ".tmp";
  {
    std::ofstream out(tmp, std::ios::binary | std::ios::trunc);
    for (auto& [k, v] : g_store[db][tbl])
      out << k.size() << ' ' << v.size() << '\n' << k << v;
  }
  fs::rename(tmp, p);
}

static bool db_exists(const std::string& db) {
  return g_store.count(db) || fs::is_directory(fs::path(g_data_dir) / db);
}

struct Txn {
  bool active = false;
  // staged writes: value, or nullopt for delete
  std::map<std::string, std::map<std::string, std::map<std::string, std::optional<std::string>>>> stage;
};

static bool read_n(int fd, char* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = read(fd, buf + got, n - got);
    if (r <= 0) return false;
    got += (size_t)r;
  }
  return true;
}

static bool write_all(int fd, const std::string& s) {
  size_t sent = 0;
  while (sent < s.size()) {
    ssize_t r = write(fd, s.data() + sent, s.size() - sent);
    if (r <= 0) return false;
    sent += (size_t)r;
  }
  return true;
}

static void reply_ok(int fd, const std::string& payload) {
  write_all(fd, "OK " + std::to_string(payload.size()) + "\n" + payload);
}

static void reply_err(int fd, const std::string& code, const std::string& msg) {
  write_all(fd, "ERR " + code + " " + msg + "\n");
}

static bool read_line(int fd, std::string& line) {
  line.clear();
  char c;
  while (true) {
    ssize_t r = read(fd, &c, 1);
    if (r <= 0) return false;
    if (c == '\n') return true;
    line.push_back(c);
    if (line.size() > 4096) return false;
  }
}

static void handle_conn(int fd) {
  Txn txn;
  std::string line;
  while (read_line(fd, line)) {
    std::istringstream hs(line);
    std::string op, db, tbl, key;
    size_t len = 0;
    hs >> op >> db >> tbl >> key >> len;
    if (op.empty()) { reply_err(fd, "EPROTO", "empty request"); break; }
    std::string payload(len, '\0');
    if (len && !read_n(fd, &payload[0], len)) break;

    if (op == "PING") { reply_ok(fd, "pong"); continue; }

    if (db != "-" && !valid_ident(db)) { reply_err(fd, "EIDENT", "bad database name"); continue; }
    if (tbl != "-" && !valid_ident(tbl)) { reply_err(fd, "EIDENT", "bad table name"); continue; }
    if (key != "-" && !valid_ident(key)) { reply_err(fd, "EIDENT", "bad key"); continue; }

    std::lock_guard<std::mutex> lk(g_mu);

    if (op == "CREATEDB") {
      fs::create_directories(fs::path(g_data_dir) / db);
      g_store[db];
      reply_ok(fd, "created");
      continue;
    }
    if (op == "DROPDB") {
      g_store.erase(db);
      std::error_code ec;
      fs::remove_all(fs::path(g_data_dir) / db, ec);
      for (auto it = g_loaded_tables.begin(); it != g_loaded_tables.end();)
        it = (it->rfind(db + "/", 0) == 0) ? g_loaded_tables.erase(it) : std::next(it);
      reply_ok(fd, "dropped");
      continue;
    }
    if (op == "BEGIN") { txn.active = true; txn.stage.clear(); reply_ok(fd, "begun"); continue; }
    if (op == "ROLLBACK") { txn.active = false; txn.stage.clear(); reply_ok(fd, "rolled back"); continue; }
    if (op == "COMMIT") {
      std::set<std::pair<std::string, std::string>> touched;
      for (auto& [d, tables] : txn.stage)
        for (auto& [t, keys] : tables) {
          load_table(d, t);
          for (auto& [k, v] : keys) {
            if (v) g_store[d][t][k] = *v;
            else g_store[d][t].erase(k);
          }
          touched.insert({d, t});
        }
      for (auto& [d, t] : touched) persist_table(d, t);
      txn.active = false;
      txn.stage.clear();
      reply_ok(fd, "committed");
      continue;
    }

    // data ops require an existing database (the 3D000 analogue)
    if (!db_exists(db)) { reply_err(fd, "ENODB", "database \"" + db + "\" does not exist"); continue; }
    load_table(db, tbl);

    if (op == "PUT") {
      if (txn.active) txn.stage[db][tbl][key] = payload;
      else { g_store[db][tbl][key] = payload; persist_table(db, tbl); }
      reply_ok(fd, "stored");
    } else if (op == "GET") {
      if (txn.active) {
        auto d = txn.stage.find(db);
        if (d != txn.stage.end()) {
          auto t = d->second.find(tbl);
          if (t != d->second.end()) {
            auto k = t->second.find(key);
            if (k != t->second.end()) {
              if (k->second) reply_ok(fd, *k->second);
              else reply_err(fd, "ENOKEY", "not found");
              continue;
            }
          }
        }
      }
      auto& t = g_store[db][tbl];
      auto it = t.find(key);
      if (it == t.end()) reply_err(fd, "ENOKEY", "not found");
      else reply_ok(fd, it->second);
    } else if (op == "DEL") {
      if (txn.active) txn.stage[db][tbl][key] = std::nullopt;
      else {
        size_t n = g_store[db][tbl].erase(key);
        if (n) persist_table(db, tbl);
      }
      reply_ok(fd, "deleted");
    } else if (op == "SCAN") {
      std::ostringstream out;
      for (auto& [k, v] : g_store[db][tbl])
        out << k.size() << ' ' << v.size() << '\n' << k << v;
      reply_ok(fd, out.str());
    } else if (op == "COUNT") {
      reply_ok(fd, std::to_string(g_store[db][tbl].size()));
    } else {
      reply_err(fd, "EPROTO", "unknown op " + op);
    }
  }
  close(fd);
}

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: piedb_server <port> <data_dir>\n");
    return 2;
  }
  int port = std::atoi(argv[1]);
  g_data_dir = argv[2];
  fs::create_directories(g_data_dir);

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (bind(srv, (sockaddr*)&addr, sizeof(addr)) != 0) {
    std::perror("bind");
    return 1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(srv, (sockaddr*)&addr, &alen);
  if (listen(srv, 64) != 0) {
    std::perror("listen");
    return 1;
  }
  std::printf("LISTENING %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);

  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread(handle_conn, fd).detach();
  }
}
